"""K1: bf16 activations × fp8/int8 weights with a float32 accumulator.

Counterpart of ``llm_fp8_tpu/kernels/quant_matmul.py``. On a CUDA tensor the
wrapper launches one of the hand-written kernels of ``csrc/quant_matmul.cu``,
which dequantize the weight on its way into the tensor cores (the weight
never exists in bf16 in device memory): the decode kernel below
:data:`PREFILL_MIN_M` rows and for every shape TMA cannot take (K not a
multiple of 8, N not of 16, unaligned operands), split across the blocks of
a cluster by :func:`split_plan`; the wgmma prefill kernel from there up. On
a CPU tensor it takes :func:`quant_matmul_plain`, the same arithmetic in
plain PyTorch.

Modes: ``tensor`` (scale ``[1, 1]``) and ``channel`` (scale ``[1, N]``)
scale the float32 accumulator after the dot; ``mx`` (bf16 power-of-two
scales ``[K/32, N]``, read by the kernels as stored) scales each 32-row
weight block before it.

A column-parallel shard (:func:`planned_as_whole`): the split of K and the
rows a block takes are planned from the shapes, so a tp rank's ``[K, N/tp]``
shard would sum its columns in another float32 order than the whole
``[K, N]`` product does. Within ``planned_as_whole(tp)`` the kernels plan
as for the whole product, and each column of the shard is the whole
product's column bit for bit.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from . import _build
from ._common import W_KINDS, aligned16, e4m3_to_bf16_ftz, num_sms

__all__ = ["quant_matmul", "quant_matmul_plain", "qdot_fused", "split_plan",
           "planned_as_whole"]

_MODES = {"tensor": 0, "channel": 1, "mx": 2}
MX_BLOCK = 32  # quant.qtensor.MX_BLOCK
_DCOLS, _DROWS = 64, 32  # csrc/quant_matmul.cu kDCols, kDRows (decode kernel)
_PBN, _PBK = 128, 64  # kPBN, kPBK (prefill kernel)
#: Decode blocks a split plan aims at for each SM: two measured faster than
#: four at every 1B projection (PERF.md), the merge over a cluster
#: costing more than the extra splits gain.
_DBLOCKS_PER_SM = 2
#: A split is a block of a thread-block cluster: 1, 2, 4 or 8 (the portable
#: cluster size).
MAX_SPLITS = 8


def _check(x, w_q, scale, mode, out_dtype):
    if x.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"quant_matmul takes 2-D x and w, got {tuple(x.shape)} "
                         f"and {tuple(w_q.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul takes bf16 activations, got {x.dtype}")
    if w_q.dtype not in W_KINDS:
        raise TypeError(f"quant_matmul takes e4m3/e5m2/int8 weights, got {w_q.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    M, K = x.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, w {tuple(w_q.shape)}")
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    want = {"tensor": 1, "channel": N, "mx": (K // MX_BLOCK) * N}[mode]
    if (mode == "mx" and K % MX_BLOCK) or scale.numel() != want:
        raise ValueError(f"{mode} scale of {tuple(scale.shape)} does not fit "
                         f"w {tuple(w_q.shape)}")
    if mode == "mx" and scale.dtype != torch.bfloat16:
        raise TypeError(f"MX scales are bf16 powers of two (quantize_mx), got {scale.dtype}")
    if not scale.dtype.is_floating_point:
        raise TypeError(f"{mode} scale must be floating point, got {scale.dtype}")
    if not (x.device == w_q.device == scale.device):
        raise ValueError("x, w_q and scale must be on one device")


def quant_matmul_plain(x, w_q, scale, *, mode: str, out_dtype=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: e4m3 dequantized to bf16 by
    the FTZ route, e5m2 and int8 exactly (as the TPU kernel's ``_dequant_to``),
    float32 products and sums, the scale after the dot or, for MX, before it."""
    out_dtype = out_dtype or x.dtype
    w = e4m3_to_bf16_ftz(w_q) if w_q.dtype == torch.float8_e4m3fn else w_q.to(torch.bfloat16)
    if mode == "mx":
        s = scale.reshape(-1, w.shape[1]).float().repeat_interleave(MX_BLOCK, dim=0)
        w = (w.float() * s).to(torch.bfloat16)
    acc = x.float() @ w.float()
    if mode != "mx":
        acc = acc * scale.float().reshape(1, -1)
    return acc.to(out_dtype)


#: The prefill kernel takes M from here up (csrc/quant_matmul.cu).
PREFILL_MIN_M = 64


def _group_rows(M: int) -> int:
    """Rows of x a decode block takes (csrc/quant_matmul.cu ``qmm_launch``):
    8, 16, 32 or, from 33 rows up, 64 (larger M loops over groups of 64)."""
    return 8 if M <= 8 else 16 if M <= 16 else 32 if M <= 32 else 64


def split_plan(M: int, N: int, K: int, sms: int = 132):
    """``(splits, k_tiles_per_split)`` of the decode kernel, from the shapes
    alone: the 32-row k tiles of each (64-column tile, group of rows) are cut
    into ``splits`` runs, the blocks of one cluster (a power of two, at most
    :data:`MAX_SPLITS`), so that the grid fills about one wave of
    ``_DBLOCKS_PER_SM`` blocks an SM, each run keeping at least 8 k tiles
    (two a warp) where K has them. Every run holds at least one k tile."""
    k_tiles = max(1, -(-K // _DROWS))
    blocks = -(-N // _DCOLS) * -(-M // _group_rows(M))
    want = min(MAX_SPLITS, _DBLOCKS_PER_SM * sms // max(1, blocks), k_tiles // 8)
    splits = 1
    while splits * 2 <= want:
        splits *= 2
    return splits, -(-k_tiles // splits)


def _prefill_splits(blocks: int, k_tiles: int, sms: int):
    """The prefill kernel's split of K: one wave of at most ``sms`` blocks
    (one fits an SM), each with at least four k tiles to pipeline; every
    split adds an [M, N] float32 partial."""
    want = max(1, min(sms // max(1, blocks), k_tiles // 4))
    per = -(-k_tiles // want)
    return -(-k_tiles // per), per


def _prefill_ok(x, w_q, M, N, K) -> bool:
    """The prefill kernel's TMA loads need K a multiple of 8, N of 16 and
    16-byte aligned x and codes."""
    return (M >= PREFILL_MIN_M and K % 8 == 0 and N % 16 == 0
            and x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)


class _Parts(threading.local):
    n = 1


#: The column-parallel group size the plans take (:func:`planned_as_whole`);
#: per thread, since a ``LocalGroup``'s ranks are threads of one process.
_PARTS = _Parts()


@contextlib.contextmanager
def planned_as_whole(parts: int):
    """Within (on this thread): K1 plans each product as for one ``parts``
    times as wide, the whole product of which it is a column-parallel
    shard: the same split of K and rows a block, so each column sums in the
    whole product's order. 1: no change."""
    prev, _PARTS.n = _PARTS.n, parts
    try:
        yield
    finally:
        _PARTS.n = prev


def launch_plan(M: int, N: int, K: int, sms: int, prefill: bool):
    """``(rows, splits, k_tiles_per_split)`` of a launch: the prefill
    kernel's 256 or 128 rows a block (256 when that grid still covers the
    card) and split of K, or the decode kernel's :func:`split_plan` (rows
    0), each planned for ``N`` times :func:`planned_as_whole`'s parts."""
    N *= _PARTS.n
    if not prefill:
        return (0, *split_plan(M, N, K, sms))
    rows = 256 if -(-M // 256) * -(-N // _PBN) >= sms else 128
    return (rows, *_prefill_splits(-(-N // _PBN) * -(-M // rows), -(-K // _PBK), sms))


def _launch(x, w_q, scale, mode, out_dtype):
    lib = _build.library("quant_matmul")
    M, K = x.shape
    N = w_q.shape[1]
    x = x.contiguous()
    # The kernels read the scales as stored: float32 tensor and channel
    # scales, bf16 MX scales (no conversion pass).
    scale = aligned16(scale.reshape(-1).to(torch.bfloat16 if mode == "mx" else torch.float32))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    p = ctypes.c_void_p
    common = (ctypes.c_int(M), ctypes.c_int(N), ctypes.c_int(K),
              ctypes.c_int(W_KINDS[w_q.dtype]), ctypes.c_int(_MODES[mode]),
              ctypes.c_int(int(out_dtype == torch.float32)))
    stream = p(torch.cuda.current_stream(x.device).cuda_stream)
    prefill = _prefill_ok(x, w_q, M, N, K)
    rows, splits, per = launch_plan(M, N, K, num_sms(x.device), prefill)
    if prefill:
        partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        err = lib.qmm_prefill_launch(
            p(x.data_ptr()), p(w_q.data_ptr()), p(scale.data_ptr()), p(out.data_ptr()),
            p(partial.data_ptr() if partial is not None else 0), *common, ctypes.c_int(rows),
            ctypes.c_int(splits), ctypes.c_int(per), stream)
    else:
        err = lib.qmm_launch(p(x.data_ptr()), p(w_q.data_ptr()), p(scale.data_ptr()),
                             p(out.data_ptr()), *common, ctypes.c_int(splits),
                             ctypes.c_int(per), stream)
    _build.check(lib, err, "quant_matmul")
    quant_matmul.launches += 1
    quant_matmul.decode_launches += int(not prefill)
    return out


def quant_matmul(
    x: torch.Tensor,  # [M, K] bf16
    w_q: torch.Tensor,  # [K, N] e4m3 / e5m2 / int8
    scale: torch.Tensor,  # [1, 1] | [1, N] | [K/32, N]
    *,
    mode: str,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x @ dequant(w_q)``: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. Counts kernel launches in ``quant_matmul.launches``,
    and of those the decode kernel's in ``quant_matmul.decode_launches``."""
    out_dtype = out_dtype or x.dtype
    _check(x, w_q, scale, mode, out_dtype)
    N = w_q.shape[1]
    if x.is_cuda:
        if w_q.stride(1) != 1 or w_q.stride(0) != N:
            raise ValueError("quant_matmul reads row-major [K, N] weight codes; these are "
                             f"strided {tuple(w_q.stride())} (laid out for the fp8native "
                             "route: quantize_params follows the qdot route in force)")
        return _launch(x, w_q, scale, mode, out_dtype)
    return quant_matmul_plain(x, w_q, scale, mode=mode, out_dtype=out_dtype)


quant_matmul.launches = 0
quant_matmul.decode_launches = 0


def qdot_fused(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` through :func:`quant_matmul` for a QTensor ``w``:
    per-tensor, per-channel (scale ``[1, N]``) or MX (block axis on K)."""
    *lead, K = x.shape
    if w.block_size is not None:
        mode = "mx"
    elif w.scale.numel() == 1:
        mode = "tensor"
    else:
        mode = "channel"
    y = quant_matmul(x.reshape(-1, K), w.qvalue, w.scale, mode=mode,
                     out_dtype=out_dtype or x.dtype)
    return y.reshape(*lead, w.qvalue.shape[-1])
