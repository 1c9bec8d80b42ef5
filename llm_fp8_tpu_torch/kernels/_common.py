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

import ctypes
import functools

from typing import Optional

import torch

__all__ = ["e4m3_to_bf16_ftz", "fp8_to_bf16_ftz", "pad_to_multiple", "aligned16",
           "PADDED_HEAD_DIMS", "pad_head_dim",
           "num_sms", "KV_KINDS", "W_KINDS", "dropout_keep_mask", "dropout_threshold",
           "dropout_seed_u32", "dropout_keep", "dropout_inv", "dropout_args",
           "alibi_slopes_tensor", "alibi_bias", "decode_alibi_bias", "live_mask",
           "segment_ids_tensor", "f32_card_refuses"]

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


def alibi_slopes_tensor(alibi_slopes, Hq: int, device, batch: Optional[int] = None
                        ) -> Optional[torch.Tensor]:
    """ALiBi slopes (a sequence or a tensor; None passes through) as the
    kernels read them: contiguous float32 on ``device``, ``[Hq]`` when
    ``batch`` is None (the decode kernels), else ``[batch, Hq]`` from ``[Hq]``
    or ``[batch, Hq]`` (the prefill and training kernels)."""
    if alibi_slopes is None:
        return None
    slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=device).detach()
    want = (Hq,) if batch is None else (batch, Hq)
    if batch is not None and slopes.ndim == 1:
        slopes = slopes[None, :].expand(batch, Hq)
    if tuple(slopes.shape) != want:
        raise ValueError(f"alibi_slopes of shape {tuple(slopes.shape)}, want [{Hq}]"
                         + ("" if batch is None else f" or [{batch}, {Hq}]"))
    return slopes.contiguous()


def alibi_bias(slopes: torch.Tensor, q_offset: torch.Tensor, Sq: int, Sk: int) -> torch.Tensor:
    """``-slope·|q_pos - k_pos|`` on absolute positions (``q_pos = q_offset +
    row``) as float32 ``[B, Hq, Sq, Sk]``, from ``[B, Hq]`` slopes and the
    ``[B]`` offsets."""
    dev = slopes.device
    q_pos = q_offset.to(dev).long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    dist = (q_pos[:, :, None] - torch.arange(Sk, device=dev)[None, None, :]).abs()
    return -(slopes[:, :, None, None] * dist[:, None].float())


def live_mask(q_offset: torch.Tensor, kv_lens: torch.Tensor, Sq: int, Sk: int, *,
              causal: bool, window: Optional[int], attention_chunk: Optional[int] = None,
              q_segment_ids: Optional[torch.Tensor] = None,
              kv_segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's and K6's live (query, key) pairs as bool ``[B, Sq, Sk]``, from
    the ``[B]`` offsets and lengths: ``k_pos < kv_len``, causal, the window,
    the query's chunk (``floor(q_pos / C)·C <= k_pos < + C``) and equal
    segment ids (``[B, Sq]`` and ``[B, Sk]``)."""
    dev = q_offset.device
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    k_pos = torch.arange(Sk, device=dev)
    mask = k_pos[None, None, :] < kv_lens.long()[:, None, None]
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    if attention_chunk is not None:
        start = torch.div(q_pos, attention_chunk, rounding_mode="floor")[:, :, None] \
            * attention_chunk
        mask = mask & (k_pos[None, None, :] >= start) & (k_pos[None, None, :] < start
                                                         + attention_chunk)
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    return mask.expand(q_pos.shape[0], Sq, Sk)


def segment_ids_tensor(q_segment_ids, kv_segment_ids, B: int, Sq: int, Sk: int, device):
    """The segment ids as the kernels read them: contiguous int32 ``[B, Sq]``
    and ``[B, Sk]`` on ``device``, or ``(None, None)``. Both or neither."""
    if q_segment_ids is None and kv_segment_ids is None:
        return None, None
    if q_segment_ids is None or kv_segment_ids is None:
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    qs = torch.as_tensor(q_segment_ids, device=device).to(torch.int32).contiguous()
    ks = torch.as_tensor(kv_segment_ids, device=device).to(torch.int32).contiguous()
    if tuple(qs.shape) != (B, Sq) or tuple(ks.shape) != (B, Sk):
        raise ValueError(f"segment ids of shapes {tuple(qs.shape)}, {tuple(ks.shape)}, want "
                         f"[{B}, {Sq}] and [{B}, {Sk}]")
    return qs, ks


def f32_card_refuses(window=None, softcap=None, attention_chunk=None, segment_ids=None):
    """Raise NotImplementedError on what K3's and K6's float32 instances do
    not take on the card: a window, a softcap, a chunk or segment ids (no
    float32 family uses them; their plain versions take all four)."""
    named = [n for n, v in (("window", window), ("softcap", softcap),
                            ("attention_chunk", attention_chunk),
                            ("segment ids", segment_ids)) if v is not None]
    if named:
        raise NotImplementedError(f"flash attention's float32 instances take no "
                                  f"{', '.join(named)} on the card")


def decode_alibi_bias(slopes: torch.Tensor, lengths: torch.Tensor, S: int, Hk: int
                      ) -> torch.Tensor:
    """The decode form ``slope·(pos - (length - 1))`` as float32 ``[B, Hk, G,
    S]`` from the ``[Hq]`` slopes (q heads in the packed GQA order, kv head
    major)."""
    pos = torch.arange(S, device=lengths.device)
    rel = (pos[None, :] - (lengths.long()[:, None] - 1)).float()  # [B, S]
    return slopes.reshape(1, Hk, -1, 1) * rel[:, None, None, :]


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------
# Attention dropout: the stateless counter hash of the TPU kernels
# --------------------------------------------------------------------------

_GOLD = 0x9E3779B9  # 2^32 / phi, the Weyl increment
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x · c mod 2^32`` for uint32 values held in int64, without leaving
    int64's range: x = hi·2^16 + lo, and hi·c's high half vanishes mod 2^32."""
    return ((x & 0xFFFF) * c + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_threshold(rate: float) -> int:
    """The uint32 a hash must reach for its entry to be kept (the TPU
    kernels' ``min(int(rate·2^32), 2^32 - 1)``)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_seed_u32(seed) -> int:
    """A seed as the int32 the TPU kernels take, read as uint32."""
    return int(seed) & _M32


def dropout_keep_mask(seed, bh, q_pos, k_pos, rate: float) -> torch.Tensor:
    """Counter-based keep mask (True = keep) of ``llm_fp8_tpu/kernels/
    _common.py::dropout_keep_mask``, bit for bit: ``fmix32(fmix32(seed +
    bh·φ) ^ (q_pos·φ + k_pos)) >= threshold`` in uint32 arithmetic, emulated
    on int64 and masked to 32 bits (``csrc/dropout.cuh`` is its device form).
    ``bh`` = batch·Hq + q head; ``bh``, ``q_pos`` and ``k_pos`` are integer
    tensors (or ints) that broadcast."""
    def u32(t):
        return torch.as_tensor(t, dtype=torch.int64) & _M32

    bh, q_pos, k_pos = u32(bh), u32(q_pos), u32(k_pos)
    h0 = _fmix32((dropout_seed_u32(seed) + _mul32(bh, _GOLD)) & _M32)
    ctr = (_mul32(q_pos, _GOLD) + k_pos) & _M32
    return _fmix32(h0 ^ ctr) >= dropout_threshold(rate)


def dropout_keep(seed, rate: float, q_offset: torch.Tensor, B: int, Hq: int, Sq: int, Sk: int
                 ) -> torch.Tensor:
    """The keep mask ``[B, Hq, Sq, Sk]`` of attention on absolute positions
    (``q_pos = q_offset + row``, ``bh = b·Hq + h``), from the ``[B]`` offsets."""
    dev = q_offset.device
    bh = torch.arange(B, device=dev)[:, None] * Hq + torch.arange(Hq, device=dev)[None, :]
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :]
    return dropout_keep_mask(seed, bh[:, :, None, None], q_pos[:, None, :, None],
                             torch.arange(Sk, device=dev)[None, None, None, :], rate)


def dropout_inv(rate: float) -> float:
    """The survivors' factor ``1/(1 - rate)`` as the float32 the kernels
    multiply by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _i32(u: int) -> ctypes.c_int:
    """A uint32 as the bits of a C int."""
    return ctypes.c_int(u - 2 ** 32 if u >= 2 ** 31 else u)


def dropout_args(dropout_p: float, dropout_seed) -> list:
    """K3's and K6's dropout arguments: the hash threshold (0: no dropout),
    the seed and the survivors' factor."""
    if dropout_p <= 0.0:
        return [_i32(0), _i32(0), ctypes.c_float(1.0)]
    return [_i32(dropout_threshold(dropout_p)), _i32(dropout_seed_u32(dropout_seed)),
            ctypes.c_float(dropout_inv(dropout_p))]


#: Head dims that no instance takes, zero-padded to one that does: the MLA
#: family's qk head dim 192 (DeepSeek-V2 and V2-Lite: 128 + 64) onto the
#: 256 instance, its debug configs' 24 (16 + 8; wgmma's bf16 K step is
#: 16) onto 32, and debug-vit's 16 (4 heads of 16, float32) onto 32. Zero
#: columns add nothing to q·k and give zero output columns, which are
#: sliced off; the scale is the unpadded dim's.
PADDED_HEAD_DIMS = {16: 32, 24: 32, 192: 256}


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t [..., D]`` zero-padded to ``d`` columns (``t`` itself at ``D == d``)."""
    return t if t.shape[-1] == d else torch.nn.functional.pad(t, (0, d - t.shape[-1]))
