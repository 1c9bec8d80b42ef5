"""K2: single-token decode attention over the KV arena, with append.

Counterpart of ``llm_fp8_tpu/kernels/decode_attention.py::decode_attention_arena``.
On a CUDA tensor the wrapper launches ``csrc/decode_attention.cu``; on a CPU
tensor it takes :func:`decode_attention_arena_plain`.

The port's arena is ``[L, B, Hk, S, D]`` (each token's D codes contiguous),
not the TPU's lane-major ``[L, B, Hk, D, S]``. The arenas are updated **in
place**: where JAX donates the buffers and returns new ones, this function
writes the new token into the tensors it was given and returns them.

The CUDA kernel splits each sequence's arena rows into runs of ``span``
keys (:func:`split_plan`, from the shapes alone, so a later CUDA graph can
capture the call) and merges the runs' partial softmaxes in order.

ALiBi (``alibi_slopes``, ``[Hq]``) adds ``slope·(pos - (length - 1))`` to
each head's scores after softcap (the decode token sits at ``length - 1``,
past every live key); ALiBi models have no rotary, so the kernel appends
without it there.

A zero-length sequence gives zeros and appends nothing, on both devices.
The TPU kernel also gives zeros (it runs no key chunk), but its append at
position -1 is an out-of-range copy of a 128-lane tile; the port writes
nothing there.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._common import (KV_KINDS, alibi_slopes_tensor, decode_alibi_bias, fp8_to_bf16_ftz,
                      num_sms)
from .paged_attention import split_plan as paged_split_plan

__all__ = ["decode_attention_arena", "decode_attention_arena_plain", "split_plan",
           "MASK_VALUE"]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_MAX_GROUPS = 8  # csrc/decode_split.cuh kMaxG

#: A split's span is a whole number of a warp's 32-key groups.
_GROUP = 32


def split_plan(batch: int, kv_heads: int, seq_len: int, sms: int = 132):
    """``(splits, span)`` of the CUDA kernel: each (kv head, sequence)'s
    ``seq_len`` arena rows are cut into ``splits`` runs of ``span`` keys (a
    multiple of 32; the last run may be shorter). K5's plan with 32-key
    groups for pages: the grid ``kv_heads · batch · splits`` fills ``sms``
    four blocks deep, in one wave. Shapes only: no length is read."""
    splits, per = paged_split_plan(batch, kv_heads, max(1, -(-seq_len // _GROUP)), sms)
    return splits, per * _GROUP


def _fmax(dtype: torch.dtype) -> Optional[float]:
    if dtype == torch.bfloat16:
        return None
    if dtype == torch.int8:
        return 127.0
    return float(torch.finfo(dtype).max)


def _rope(x, cos, sin):
    """Rotate-half rotary as the TPU kernel computes it (float32):
    ``x * [cos|cos] + [-x2|x1] * [sin|sin]``; cos/sin ``[B, D/2]`` broadcast
    over the head axes of ``x [B, ..., D]``."""
    half = x.shape[-1] // 2
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    c = torch.cat([cos, cos], dim=-1).reshape(shape)
    s = torch.cat([sin, sin], dim=-1).reshape(shape)
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rot * s


def _quantize_token(x, scale, dtype):
    """Divide by the per-head scale, clip (narrow formats), round (int8), cast."""
    y = x / scale
    fmax = _fmax(dtype)
    if fmax is None:
        return y.to(dtype)
    y = torch.clamp(y, -fmax, fmax)
    if dtype == torch.int8:
        y = torch.round(y)
    return y.to(dtype)


def decode_attention_arena_plain(q, k_arena, v_arena, lengths, layer_idx, *,
                                 new_k, new_v, cos, sin, k_scale, v_scale,
                                 scale, window, softcap, alibi=None):
    """The kernel's function in plain PyTorch. Appends in place when
    ``new_k`` is given; returns ``out [B, Hq, D]``."""
    B, Hq, D = q.shape
    Hk = k_arena.shape[2]
    g = Hq // Hk
    lengths = lengths.long()
    ks = k_scale.reshape(1, Hk, 1)
    vs = v_scale.reshape(1, Hk, 1)
    qf = q.float().reshape(B, Hk, g, D)
    if cos is not None:
        qf = _rope(qf, cos, sin)
    ka, va = k_arena[layer_idx], v_arena[layer_idx]  # views [B, Hk, S, D]
    live = lengths > 0
    if new_k is not None:
        kq = new_k.to(torch.bfloat16).float()
        if cos is not None:
            kq = _rope(kq, cos, sin)
        vq = new_v.to(torch.bfloat16).float()
        # Row lengths-1 of each sequence; a zero-length sequence writes its
        # row 0 back unchanged (no host sync, so a graph can capture it).
        bidx = torch.arange(B, device=q.device)
        last = (lengths - 1).clamp(min=0)
        for arena, new, sc in ((ka, kq, ks), (va, vq, vs)):
            bits = arena.view(torch.int16 if arena.element_size() == 2 else torch.uint8)
            codes = _quantize_token(new, sc, arena.dtype).view(bits.dtype)
            bits[bidx, :, last] = torch.where(live[:, None, None], codes, bits[bidx, :, last])
    qs = (qf * (scale * k_scale).reshape(1, Hk, 1, 1)).to(torch.bfloat16).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qs, fp8_to_bf16_ftz(ka).float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if alibi is not None:
        s = s + decode_alibi_bias(alibi, lengths, ka.shape[2], Hk)
    pos = torch.arange(ka.shape[2], device=q.device)
    mask = pos[None, :] < lengths[:, None]
    if window is not None:
        mask = mask & (pos[None, :] > (lengths[:, None] - 1) - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(torch.bfloat16).float(),
                       fp8_to_bf16_ftz(va).float())
    vsc = v_scale.reshape(1, Hk, 1, 1)
    l_inv = torch.where(l == 0.0, torch.ones_like(l), vsc / l)
    out = torch.where(live[:, None, None, None], acc * l_inv, torch.zeros_like(acc))
    return out.to(q.dtype).reshape(B, Hq, D)


def _launch(q, k_arena, v_arena, lengths, layer_idx, new_k, new_v, cos, sin,
            k_scale, v_scale, scale, window, softcap, alibi):
    lib = _build.library("decode_attention")
    B, Hq, D = q.shape
    L, _, Hk, S, _ = k_arena.shape
    splits, span = split_plan(B, Hk, S, num_sms(q.device))
    out = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=q.device)
    rows = B * Hk * splits * (Hq // Hk)
    part = torch.empty((rows * (D + 2),), dtype=torch.float32, device=q.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    err = lib.decode_arena_launch(
        ptr(q), ptr(k_arena), ptr(v_arena), ptr(lengths), ctypes.c_int(layer_idx),
        ptr(new_k), ptr(new_v), ptr(cos), ptr(sin), ptr(k_scale), ptr(v_scale),
        ptr(alibi), ptr(out), ptr(part), ptr(part[rows:]), ptr(part[2 * rows:]), ctypes.c_int(B),
        ctypes.c_int(Hq), ctypes.c_int(Hk), ctypes.c_int(S), ctypes.c_int(D),
        ctypes.c_int(KV_KINDS[k_arena.dtype]), ctypes.c_int(splits), ctypes.c_int(span),
        ctypes.c_float(scale), ctypes.c_int(window or 0),
        ctypes.c_float(softcap or 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(lib, err, "decode_attention_arena")
    decode_attention_arena.launches += 1
    return out


def decode_attention_arena(
    q: torch.Tensor,  # [B, Hq, D]
    k_arena: torch.Tensor,  # [L, B, Hk, S, D] e4m3 / e5m2 / int8 / bf16
    v_arena: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid tokens, including the one appended
    layer_idx: int = 0,
    *,
    new_k: Optional[torch.Tensor] = None,  # [B, Hk, D] unquantized new token
    new_v: Optional[torch.Tensor] = None,
    rope_cos_sin: Optional[tuple] = None,  # (cos, sin) [B, D/2] float32
    k_scale=1.0,  # scalar or [Hk] per-head descale
    v_scale=1.0,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    alibi_slopes=None,
):
    """Single-token flash decode over the arena.

    With ``new_k``/``new_v`` the new token is rotated (``rope_cos_sin``),
    quantized by the per-head descales and written at ``lengths - 1`` of
    layer ``layer_idx`` in place, then attended over; returns ``(out,
    k_arena, v_arena)``. Without them it only attends and returns ``out``.
    ``alibi_slopes``: ``[Hq]`` floats (a tensor on q's device is read in
    place). Counts kernel launches in ``decode_attention_arena.launches``.
    """
    B, Hq, D = q.shape
    if k_arena.ndim != 5 or k_arena.shape != v_arena.shape or k_arena.dtype != v_arena.dtype:
        raise ValueError(f"arenas must be matching [L, B, Hk, S, D], got "
                         f"{tuple(k_arena.shape)} and {tuple(v_arena.shape)}")
    L, B2, Hk, S, D2 = k_arena.shape
    if B2 != B or D2 != D or Hq % Hk or Hq // Hk > _MAX_GROUPS:
        raise ValueError(f"q {tuple(q.shape)} does not fit arena {tuple(k_arena.shape)} "
                         f"(at most {_MAX_GROUPS} q heads per kv head)")
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} not in (32, 64, 128)")
    if k_arena.dtype not in KV_KINDS:
        raise TypeError(f"arena dtype {k_arena.dtype} not in {list(KV_KINDS)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode attention takes bf16 q, got {q.dtype}")
    append = new_k is not None
    if rope_cos_sin is not None and not append:
        raise ValueError("in-kernel rotary rides the append path")
    dev = q.device
    layer_idx = int(layer_idx)
    scale = scale if scale is not None else D ** -0.5
    k_scale = torch.as_tensor(k_scale, dtype=torch.float32, device=dev).expand(Hk).contiguous()
    v_scale = torch.as_tensor(v_scale, dtype=torch.float32, device=dev).expand(Hk).contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    cos = sin = None
    if rope_cos_sin is not None:
        cos, sin = (t.to(device=dev, dtype=torch.float32).contiguous() for t in rope_cos_sin)
    if append:
        new_k = new_k.to(torch.bfloat16).contiguous()
        new_v = new_v.to(torch.bfloat16).contiguous()
    alibi = alibi_slopes_tensor(alibi_slopes, Hq, dev)
    args = dict(new_k=new_k, new_v=new_v, cos=cos, sin=sin, k_scale=k_scale,
                v_scale=v_scale, scale=scale, window=window, softcap=softcap, alibi=alibi)
    if not (k_arena.device == v_arena.device == dev
            and (new_k is None or new_k.device == new_v.device == dev)):
        raise ValueError("q, the arenas and the new token must be on one device")
    if q.is_cuda:
        if not (k_arena.is_contiguous() and v_arena.is_contiguous()):
            raise ValueError("the arenas must be contiguous")
        out = _launch(q.contiguous(), k_arena, v_arena, lengths, layer_idx,
                      args["new_k"], args["new_v"], cos, sin, k_scale, v_scale,
                      scale, window, softcap, alibi)
    else:
        out = decode_attention_arena_plain(q, k_arena, v_arena, lengths, layer_idx, **args)
    return (out, k_arena, v_arena) if append else out


decode_attention_arena.launches = 0
