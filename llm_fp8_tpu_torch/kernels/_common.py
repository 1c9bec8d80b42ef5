"""Shared kernel-side helpers (counterpart of ``llm_fp8_tpu/kernels/_common.py``).

The TPU kernels dequantize fp8 by a shift into the bf16 bit pattern and one
power-of-two multiply; format subnormals land on bf16 subnormals, which the
TPU flushes, so they dequantize to ±0 (FTZ). Hopper's ``cvt`` and float
arithmetic are exact on subnormals, so both these plain versions and the
device functions in ``csrc/fp8_ftz.cuh`` flush explicitly: exponent field 0
→ ±0. Every other code, including e4m3 0x7F/0xFF (±480 on this route), maps
as on the TPU.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["e4m3_to_bf16_ftz", "fp8_to_bf16_ftz", "pad_to_multiple", "aligned16",
           "num_sms", "KV_KINDS", "W_KINDS"]

#: dtype → kind code of ``csrc/fp8_ftz.cuh`` (``kCodeE4M3`` ...).
W_KINDS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1, torch.int8: 2}
KV_KINDS = {**W_KINDS, torch.bfloat16: 3}


def _shift_ftz(x: torch.Tensor, shift: int, exp_mask: int, rebias: float) -> torch.Tensor:
    i = x.view(torch.uint8).to(torch.int32)
    sign = (i & 0x80) << 24
    bits = torch.where((i & exp_mask) == 0, sign, sign | ((i & 0x7F) << shift))
    return (bits.view(torch.float32) * rebias).to(torch.bfloat16)


def e4m3_to_bf16_ftz(w: torch.Tensor) -> torch.Tensor:
    """e4m3fn → bf16, subnormal codes flushed to ±0 (×2^120 rebias)."""
    return _shift_ftz(w, 20, 0x78, 2.0 ** 120)


def fp8_to_bf16_ftz(x: torch.Tensor) -> torch.Tensor:
    """fp8 (e4m3fn / e5m2) → bf16 by the FTZ route; other dtypes convert
    exactly (int8 fits bf16's 8-bit significand)."""
    if x.dtype == torch.float8_e4m3fn:
        return e4m3_to_bf16_ftz(x)
    if x.dtype == torch.float8_e5m2:
        return _shift_ftz(x, 21, 0x7C, 2.0 ** 112)
    return x.to(torch.bfloat16)


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to the next multiple (no-op when aligned)."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad_shape = list(x.shape)
    pad_shape[axis] = rem
    return torch.cat([x, x.new_zeros(pad_shape)], dim=axis)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels' vector and TMA
    loads need both); copies only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count
