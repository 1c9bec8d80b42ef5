"""K9: one-pass per-row or per-column amax + quantize of a 2-D operand.

Counterpart of ``llm_fp8_tpu/kernels/quantize.py::quantize_fused``. On a
CUDA tensor the wrapper launches ``csrc/quantize.cu``; on a CPU tensor it
takes :func:`quantize_fused_plain`. Both store the codes and scales of
``quant.quantize(x, fmt, axes=(axis,), margin=margin)`` bit for bit:
``scale = max(amax, tiny) / fmax · 2^margin`` (a true division), then
``clip(x / scale)``, round half to even for integers, and the saturating
cast.

The TPU kernel falls back to XLA's two-pass quantize past its VMEM limits
(rows longer than 65536, columns taller than 4096, ``quant/dot.py:207,215``);
the CUDA kernel streams any length, so the port has no such guard.
"""
from __future__ import annotations

import ctypes

import torch

from ..quant.formats import Format
from ..quant.qtensor import QTensor, compute_scale
from . import _build
from ._common import W_KINDS

__all__ = ["quantize_fused", "quantize_fused_plain"]

#: Input dtype → kind code of ``csrc/quantize.cu``.
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def quantize_fused_plain(x: torch.Tensor, fmt: Format, *, axis: int = -1,
                         margin: int = 0) -> QTensor:
    """The kernel's function in plain PyTorch: ``axis`` is reduced over for
    the amax (``-1``/``1``: scales ``[M, 1]``; ``0``: scales ``[1, N]``)."""
    x32 = x.float()
    scale = compute_scale(x32.abs().amax(dim=axis % 2, keepdim=True), fmt, margin)
    q = torch.clamp(x32 / scale, -fmt.max, fmt.max)
    if fmt.is_integer:
        q = torch.round(q)
    return QTensor(qvalue=q.to(fmt.dtype), scale=scale, fmt=fmt)


def quantize_fused(x: torch.Tensor, fmt: Format, *, axis: int = -1,
                   margin: int = 0) -> QTensor:
    """One-pass per-channel quantization of a 2-D bf16 or float32 operand.

    ``axis`` is the axis reduced over for the amax (the contraction axis of
    the dot that consumes the result). Counts kernel launches in
    ``quantize_fused.launches``.
    """
    if x.ndim != 2:
        raise ValueError(f"quantize_fused wants 2-D input, got {tuple(x.shape)}")
    if x.dtype not in _IN_KINDS:
        raise TypeError(f"quantize_fused takes float32 or bf16 input, got {x.dtype}")
    if fmt.dtype not in W_KINDS or fmt.name == "int4":
        raise ValueError(f"quantize_fused stores e4m3, e5m2 or int8, not {fmt.name}")
    axis = axis % 2
    if not x.is_cuda:
        return quantize_fused_plain(x, fmt, axis=axis, margin=margin)
    if x.numel() == 0:
        raise ValueError(f"quantize_fused: empty input {tuple(x.shape)}")
    x = x.contiguous()
    M, N = x.shape
    q = torch.empty((M, N), dtype=fmt.dtype, device=x.device)
    scale = torch.empty((M, 1) if axis == 1 else (1, N), dtype=torch.float32,
                        device=x.device)
    lib = _build.library("quantize")
    err = lib.quantize_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(scale.data_ptr()), ctypes.c_int(M), ctypes.c_int(N),
        ctypes.c_int(_IN_KINDS[x.dtype]), ctypes.c_int(W_KINDS[fmt.dtype]),
        ctypes.c_int(axis), ctypes.c_float(fmt.max), ctypes.c_float(2.0 ** margin),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(lib, err, "quantize_fused")
    quantize_fused.launches += 1
    return QTensor(qvalue=q, scale=scale, fmt=fmt)


quantize_fused.launches = 0
