"""Carry parameters from the JAX package into the port.

``params_from_numpy(tree, device)`` takes the JAX package's parameter tree
with every array given as a numpy array and every ``QTensor`` given as a dict
of its fields (``qvalue``, ``scale``, ``fmt`` as the format's name,
``block_size``, ``block_axis``, ``pack_axis``), and returns the port's tree
on ``device``. bf16 and fp8 arrays are read through their dtype *name* and a
``uint16``/``uint8`` view, so no ``ml_dtypes`` import is needed.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .quant.formats import format_by_name
from .quant.qtensor import QTensor

__all__ = ["params_from_numpy", "tensor_from_numpy"]

_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (bf16/fp8 included, by dtype name) as a torch tensor."""
    a = np.asarray(a)
    view = _VIEWS.get(a.dtype.name)
    if view is not None:
        bits = np.ascontiguousarray(a).view(view[0])
        t = torch.from_numpy(bits.copy()).view(view[1])
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Convert a nested dict of numpy arrays / QTensor field dicts."""
    if isinstance(tree, dict) and "qvalue" in tree:
        return QTensor(
            qvalue=tensor_from_numpy(tree["qvalue"], device),
            scale=tensor_from_numpy(tree["scale"], device),
            fmt=format_by_name(tree["fmt"]),
            block_size=tree.get("block_size"),
            block_axis=tree.get("block_axis"),
            pack_axis=tree.get("pack_axis"),
        )
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
