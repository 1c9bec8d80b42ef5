"""Carry parameters from the JAX package into the port.

``params_from_numpy(tree, device)`` takes the JAX package's parameter tree
with every array given as a numpy array and every ``QTensor`` given as a dict
of its fields (``qvalue``, ``scale``, ``fmt`` as the format's name,
``block_size``, ``block_axis``, ``pack_axis``), and returns the port's tree
on ``device`` (any shape: an MoE tree's 4-D expert QTensors, with ``[L, E,
1, N]`` channel scales or MX blocks along axis 2, carry as the rest; the MLA
family's two groups, ``dense_layers`` and ``moe_layers``, are nested dicts
like ``layers``). bf16 and fp8 arrays are read through their dtype *name* and a
``uint16``/``uint8`` view, so no ``ml_dtypes`` import is needed.

``pool_from_numpy`` carries a JAX paged KV pool (``[P, L, Hk, D, page]``,
lane-major) into the port's ``[P, L, Hk, page, D]``; ``pool_to_numpy`` goes
back, as the codes' bits.

Training state: ``params_from_numpy`` carries float32 master weights;
``tree_to_numpy`` brings a tree of float32 tensors back; the delayed-scaling
state (``{site: {"x"/"w"/"g": ScaleState}}``, each given as a dict of
``history`` and ``scale`` numpy arrays) goes across with
``quant_state_from_numpy`` and back with ``quant_state_to_numpy``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .quant.delayed import ScaleState
from .quant.formats import format_by_name
from .quant.qtensor import QTensor

__all__ = ["params_from_numpy", "tensor_from_numpy", "pool_from_numpy", "pool_to_numpy",
           "tree_to_numpy", "quant_state_from_numpy", "quant_state_to_numpy"]

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


def pool_from_numpy(a, device="cpu") -> torch.Tensor:
    """A JAX page pool ``[P, L, Hk, D, page]`` (numpy) as the port's
    ``[P, L, Hk, page, D]`` tensor, code for code."""
    return tensor_from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(a), -1, -2)), device)


def pool_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The port's pool ``[P, L, Hk, page, D]`` in the JAX layout
    ``[P, L, Hk, D, page]``, as the codes' bits: ``uint16`` for bf16,
    ``uint8`` for the one-byte kinds (``.view`` of the caller's dtype gives
    the values)."""
    bits = t.detach().cpu().contiguous().view(torch.int16 if t.element_size() == 2
                                              else torch.uint8).numpy()
    return np.ascontiguousarray(np.swapaxes(bits, -1, -2).view(
        np.uint16 if t.element_size() == 2 else np.uint8))


def tree_to_numpy(tree: Any) -> Any:
    """A nested dict of float32 (or integer) tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def quant_state_from_numpy(tree: Any, device="cpu") -> Any:
    """``{site: {t: {"history", "scale"}}}`` of numpy arrays as the port's
    ``{site: {t: ScaleState}}``."""
    return {site: {t: ScaleState(history=tensor_from_numpy(st["history"], device),
                                 scale=tensor_from_numpy(st["scale"], device))
                   for t, st in per.items()} for site, per in tree.items()}


def quant_state_to_numpy(qstate: Any) -> Any:
    """The port's delayed-scaling state as ``{site: {t: {"history", "scale"}}}``."""
    return {site: {t: {"history": tree_to_numpy(st.history), "scale": tree_to_numpy(st.scale)}
                   for t, st in per.items()} for site, per in qstate.items()}
