"""Quantized matmul, inference path (counterpart of ``llm_fp8_tpu/quant/dot.py::qdot``).

The JAX package's default route on the TPU is XLA's convert+dot, where XLA
fuses the e4m3→bf16 convert into the operand read. PyTorch has no such
fusion: ``w.to(bf16)`` then ``matmul`` would write a bf16 copy of every
weight and read it back. So every fp8/int8 QTensor goes through K1
(:func:`..kernels.quant_matmul.qdot_fused`), the counterpart of the JAX
``"fused"`` route. The training path (``fp8_dot``) is not ported yet.
"""
from __future__ import annotations

import torch

from ..kernels.quant_matmul import qdot_fused
from .qtensor import QTensor

__all__ = ["qdot"]


def _scale_is_post_applicable(w: QTensor) -> bool:
    return w.scale.ndim == 0 or all(d == 1 for d in w.scale.shape[:-1])


def qdot(x: torch.Tensor, w: QTensor, *, out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with ``w`` stored quantized (fp8 or int8,
    unpacked; per-tensor, per-channel or MX scales)."""
    if w.pack_axis is not None:
        raise NotImplementedError("qdot: int4 (packed) weights are not ported yet")
    if w.block_size is None and not _scale_is_post_applicable(w):
        raise NotImplementedError("qdot: group-wise scales are not ported yet")
    return qdot_fused(x, w, out_dtype=out_dtype or x.dtype)
