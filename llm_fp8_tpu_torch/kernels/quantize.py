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
the CUDA kernel takes any length, so the port has no such guard. Its
route (:func:`route`) follows from ``(M, N, dtype, axis)`` alone: rows in
registers, in shared memory, or read twice past that; columns in one
thread-block cluster, or read twice past what a cluster holds.
"""
from __future__ import annotations

import ctypes

import torch

from ..quant.formats import Format
from ..quant.qtensor import QTensor, compute_scale
from . import _build
from ._common import W_KINDS

__all__ = ["quantize_fused", "quantize_fused_plain", "route", "ROUTES"]

#: Input dtype → kind code of ``csrc/quantize.cu``.
_IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}

#: The CUDA kernel's routes, in the order of its route codes.
ROUTES = ("rows_regs", "rows_smem", "rows_stream", "cols_cluster", "cols_stream")
_ROW_WARPS_MAX, _LANE_ELEMS = 16, 32  # rows_regs: warps a row, elements a lane
_SMEM_MAX = 192 * 1024  # dynamic shared memory a block stages
_CLUSTER, _STRIP = 8, 32  # cols_cluster: blocks splitting M, columns a strip


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def route(M: int, N: int, dtype: torch.dtype, axis: int):
    """``(name, warps, vecs)``: the CUDA kernel's route for an ``[M, N]``
    operand of ``dtype`` reduced over ``axis``, from the shapes alone.
    ``warps`` (warps a row) and ``vecs`` (16-byte vectors a lane) are
    ``rows_regs``' and 0 for the other routes.

    * rows (axis 1): ``rows_regs`` while the row fits 16 warps x 32 lanes x 32
      elements (N <= 16384; fewest warps first, then the fewest power-of-two
      vectors a lane), ``rows_smem`` while it fits 192 KiB of shared memory,
      else ``rows_stream`` (read twice);
    * columns (axis 0): ``cols_cluster`` while a cluster of 8 blocks holds
      the 32-column strip (ceil(M/8) x 32 elements in 192 KiB each: M <=
      12288 float32, 24576 bf16), else ``cols_stream`` (read twice).
    """
    esize = torch.empty((), dtype=dtype).element_size()
    if axis % 2 == 1:
        nv = -(-N // (16 // esize))  # 16-byte vectors a row
        vecs_max = _LANE_ELEMS // (16 // esize)
        if nv <= _ROW_WARPS_MAX * 32 * vecs_max:
            warps = _pow2(-(-nv // (32 * vecs_max)))
            return "rows_regs", warps, _pow2(-(-nv // (32 * warps)))
        return ("rows_smem" if nv * 16 <= _SMEM_MAX else "rows_stream"), 0, 0
    fits = -(-M // _CLUSTER) * _STRIP * esize <= _SMEM_MAX
    return ("cols_cluster" if fits else "cols_stream"), 0, 0


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
    name, warps, vecs = route(M, N, x.dtype, axis)
    lib = _build.library("quantize")
    err = lib.quantize_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(q.data_ptr()),
        ctypes.c_void_p(scale.data_ptr()), ctypes.c_int(M), ctypes.c_int(N),
        ctypes.c_int(_IN_KINDS[x.dtype]), ctypes.c_int(W_KINDS[fmt.dtype]),
        ctypes.c_int(ROUTES.index(name)), ctypes.c_int(warps), ctypes.c_int(vecs),
        ctypes.c_float(fmt.max), ctypes.c_float(2.0 ** margin),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    _build.check(lib, err, "quantize_fused")
    quantize_fused.launches += 1
    return QTensor(qvalue=q, scale=scale, fmt=fmt)


quantize_fused.launches = 0
