"""K1: bf16 activations × fp8/int8 weights with a float32 accumulator.

Counterpart of ``llm_fp8_tpu/kernels/quant_matmul.py``. On a CUDA tensor the
wrapper launches one of the hand-written kernels of ``csrc/quant_matmul.cu``,
which dequantize the weight on its way into the tensor cores (the weight
never exists in bf16 in device memory): the decode kernel below
:data:`PREFILL_MIN_M` rows (and where TMA cannot take the shape: K not a
multiple of 8, N not of 16), the wgmma prefill kernel from there up. On a
CPU tensor it takes :func:`quant_matmul_plain`, the same arithmetic in
plain PyTorch.

Modes: ``tensor`` (scale ``[1, 1]``) and ``channel`` (scale ``[1, N]``)
scale the float32 accumulator after the dot; ``mx`` (bf16 power-of-two
scales ``[K/32, N]``) scales each 32-row weight block before it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._common import W_KINDS, e4m3_to_bf16_ftz, num_sms

__all__ = ["quant_matmul", "quant_matmul_plain", "qdot_fused"]

_MODES = {"tensor": 0, "channel": 1, "mx": 2}
MX_BLOCK = 32  # quant.qtensor.MX_BLOCK
_BN, _BK = 128, 64  # csrc/quant_matmul.cu kBN, kBK (decode kernel)
_PBN, _PBK = 128, 64  # kPBN, kPBK (prefill kernel)


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


def _splits(blocks: int, k_tiles: int, sms: int):
    """``(splits, k_tiles_per_split)`` of the decode kernel: split K so that
    about two waves of blocks stream the weight when the (M, N) grid alone
    cannot."""
    if blocks >= 2 * sms:
        return 1, k_tiles
    per = -(-k_tiles // min(k_tiles, -(-2 * sms // blocks)))
    return -(-k_tiles // per), per


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


def _launch(x, w_q, scale, mode, out_dtype):
    lib = _build.library("quant_matmul")
    M, K = x.shape
    N = w_q.shape[1]
    x = x.contiguous()
    scale32 = scale.reshape(-1).to(torch.float32).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    sms = num_sms(x.device)
    prefill = _prefill_ok(x, w_q, M, N, K)
    if prefill:
        # 256 rows a block when that grid still covers the card, else 128.
        rows = 256 if -(-M // 256) * -(-N // _PBN) >= sms else 128
        splits, per = _prefill_splits(-(-N // _PBN) * -(-M // rows), -(-K // _PBK), sms)
    else:
        small = M <= 16
        splits, per = _splits(-(-N // _BN) * -(-M // (16 if small else 64)), -(-K // _BK), sms)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    args = (ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(w_q.data_ptr()),
            ctypes.c_void_p(scale32.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(partial.data_ptr() if partial is not None else 0),
            ctypes.c_int(M), ctypes.c_int(N), ctypes.c_int(K),
            ctypes.c_int(W_KINDS[w_q.dtype]), ctypes.c_int(_MODES[mode]),
            ctypes.c_int(int(out_dtype == torch.float32)))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    if prefill:
        err = lib.qmm_prefill_launch(*args, ctypes.c_int(rows), ctypes.c_int(splits),
                                     ctypes.c_int(per), stream)
    else:
        err = lib.qmm_launch(*args, ctypes.c_int(int(small)), ctypes.c_int(splits),
                             ctypes.c_int(per), stream)
    _build.check(lib, err, "quant_matmul")
    quant_matmul.launches += 1
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
    version on a CPU tensor. Counts kernel launches in ``quant_matmul.launches``."""
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
