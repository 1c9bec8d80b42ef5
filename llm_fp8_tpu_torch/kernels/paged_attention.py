"""K5: single-token decode attention over the paged KV pool, with append.

Counterpart of ``llm_fp8_tpu/kernels/paged_attention.py::paged_attention``.
On a CUDA tensor the wrapper launches ``csrc/paged_attention.cu``; on a CPU
tensor it takes :func:`paged_attention_plain`.

The port's pools are ``[P, L, Hk, page, D]`` (each token's D codes
contiguous), not the TPU's lane-major ``[P, L, Hk, D, page]``. Token ``t`` of
sequence ``b`` lives in page ``page_tables[b, t // page]`` at row
``t % page``; table ids are clamped to ``[0, P - 1]`` as on the TPU, so
padding may be any value. The pools are updated **in place**: where JAX
aliases them to the kernel's outputs, this function writes the new token
into the tensors it was given and returns them.

The CUDA kernel splits each sequence into runs of pages
(:func:`split_plan`, from the shapes alone, so a later CUDA graph can
capture the call) and merges the runs' partial softmaxes in order.

The plain version takes one softmax maximum over the whole sequence, while
the TPU kernel tiles ``min(8, max_pages) · page`` keys and the CUDA kernel
keeps one maximum per warp and split: they agree up to where p is rounded
to bf16 (identical when the TPU's one tile covers the sequence).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._common import (KV_KINDS, alibi_slopes_tensor, decode_alibi_bias, fp8_to_bf16_ftz,
                      num_sms)

__all__ = ["paged_attention", "paged_attention_plain", "quantize_to_pool", "split_plan",
           "split_ranges", "MASK_VALUE"]

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_MAX_GROUPS = 8  # csrc/paged_attention.cu kMaxG
_PAGE_MULTIPLE = 16


def quantize_to_pool(x: torch.Tensor, kv_scale: float, dtype: torch.dtype) -> torch.Tensor:
    """K/V values into pool codes as the TPU kernel stores them: float32
    divide by ``kv_scale``, clip to the storage range (narrow kinds), round
    to nearest even (int8), cast. A bf16 pool is divided but not clipped.

    The divisor is a tensor on ``x``'s device: on a card PyTorch turns the
    division by a Python float into a multiplication by its reciprocal,
    which can round differently. (``torch.full`` and no host copy, so that
    the function can be captured in a CUDA graph.)"""
    y = x.float() / torch.full((), kv_scale, dtype=torch.float32, device=x.device)
    if dtype == torch.bfloat16:
        return y.to(dtype)
    fmax = 127.0 if dtype == torch.int8 else float(torch.finfo(dtype).max)
    y = torch.clamp(y, -fmax, fmax)
    if dtype == torch.int8:
        y = torch.round(y)
    return y.to(dtype)


#: Blocks of the CUDA kernel an SM holds at once (four warps each; shared
#: memory and registers allow four at D = 64): the grid aims at one wave.
_BLOCKS_PER_SM = 4


def split_plan(batch: int, kv_heads: int, max_pages: int, sms: int = 132):
    """``(splits, pages_per_split)`` of the CUDA kernel: each (kv head,
    sequence) is cut into ``splits`` runs of ``pages_per_split`` pages of its
    table (the last run may be shorter), so that the grid ``kv_heads ·
    batch · splits`` fills ``sms`` with ``_BLOCKS_PER_SM`` blocks each, in
    one wave. Shapes only: no length is read."""
    want = max(1, _BLOCKS_PER_SM * sms // max(1, batch * kv_heads))
    per = -(-max_pages // max(1, min(max_pages, want)))
    return -(-max_pages // per), per


def split_ranges(length: int, page: int, splits: int, pages_per_split: int, window=None):
    """The key positions ``[lo, hi)`` each split attends for a sequence of
    ``length`` tokens (the kernel's arithmetic; an empty range is a split
    with nothing to read)."""
    span = pages_per_split * page
    start = max(0, length - window) if window else 0
    return [(max(z * span, start), min(length, (z + 1) * span)) for z in range(splits)]


def paged_attention_plain(q, k_pages, v_pages, lengths, page_tables, layer_idx, *,
                          new_k, new_v, scale, kv_scale, window, softcap, alibi=None):
    """The kernel's function in plain PyTorch. Appends in place when
    ``new_k`` is given; returns ``out [B, Hq, D]``."""
    B, Hq, D = q.shape
    P, _, Hk, page, _ = k_pages.shape
    g = Hq // Hk
    max_pages = page_tables.shape[1]
    dev = q.device
    lengths = lengths.long().clamp(0, max_pages * page)
    tables = page_tables.long().clamp(0, P - 1)
    kl, vl = k_pages[:, layer_idx], v_pages[:, layer_idx]  # views [P, Hk, page, D]
    if new_k is not None:
        # Row lengths-1 of each sequence; a zero-length sequence writes its
        # row 0 back unchanged, as the TPU kernel's tile read-modify-write
        # does (no host sync, so the function can be captured in a graph).
        live = (lengths >= 1)[:, None, None]
        last = (lengths - 1).clamp(min=0)
        pid, off = tables[torch.arange(B, device=dev), last // page], last % page
        for pool, new in ((kl, new_k), (vl, new_v)):
            bits = pool.view(torch.int16 if pool.element_size() == 2 else torch.uint8)
            codes = quantize_to_pool(new, kv_scale, pool.dtype).view(bits.dtype)
            bits[pid, :, off] = torch.where(live, codes, bits[pid, :, off])

    def gather(pool):  # [B, Hk, max_pages * page, D], as bf16 values in float32
        x = fp8_to_bf16_ftz(pool[tables]).float()  # [B, max_pages, Hk, page, D]
        return x.permute(0, 2, 1, 3, 4).reshape(B, Hk, max_pages * page, D)

    qs = (q.float().reshape(B, Hk, g, D) * (scale * kv_scale)).to(torch.bfloat16).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qs, gather(kl))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if alibi is not None:
        s = s + decode_alibi_bias(alibi, lengths, max_pages * page, Hk)
    pos = torch.arange(max_pages * page, device=dev)
    mask = pos[None, :] < lengths[:, None]
    if window is not None:
        mask = mask & (pos[None, :] > (lengths[:, None] - 1) - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(torch.bfloat16).float(), gather(vl))
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    out = acc * (l_inv * kv_scale)
    out = torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype).reshape(B, Hq, D)


def _launch(q, k_pages, v_pages, lengths, tables, layer_idx, new_k, new_v, scale,
            kv_scale, window, softcap, alibi):
    lib = _build.library("paged_attention")
    B, Hq, D = q.shape
    P, L, Hk, page, _ = k_pages.shape
    splits, pps = split_plan(B, Hk, tables.shape[1], num_sms(q.device))
    out = torch.empty((B, Hq, D), dtype=torch.bfloat16, device=q.device)
    rows = B * Hk * splits * (Hq // Hk)
    part = torch.empty((rows * (D + 2),), dtype=torch.float32, device=q.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    err = lib.paged_attn_launch(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(lengths), ptr(tables), ptr(new_k),
        ptr(new_v), ptr(alibi), ptr(out), ptr(part), ptr(part[rows:]), ptr(part[2 * rows:]),
        ctypes.c_int(B), ctypes.c_int(Hq), ctypes.c_int(Hk),
        ctypes.c_int(D), ctypes.c_int(P), ctypes.c_int(L), ctypes.c_int(page),
        ctypes.c_int(tables.shape[1]), ctypes.c_int(layer_idx),
        ctypes.c_int(KV_KINDS[k_pages.dtype]), ctypes.c_int(splits), ctypes.c_int(pps),
        ctypes.c_float(scale * kv_scale),
        ctypes.c_float(kv_scale), ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(lib, err, "paged_attention")
    paged_attention.launches += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [B, Hq, D] bf16
    k_pages: torch.Tensor,  # [P, L, Hk, page, D] e4m3 / e5m2 / int8 / bf16
    v_pages: torch.Tensor,
    lengths: torch.Tensor,  # [B] valid tokens, including the one appended
    page_tables: torch.Tensor,  # [B, max_pages] physical page ids
    layer_idx: int = 0,
    *,
    scale: Optional[float] = None,
    kv_scale: float = 1.0,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    alibi_slopes=None,
    new_k: Optional[torch.Tensor] = None,  # [B, Hk, D] rotated, unquantized new token
    new_v: Optional[torch.Tensor] = None,
):
    """Single-token flash decode over the paged pool.

    With ``new_k``/``new_v`` the new token is quantized by ``kv_scale`` and
    written at ``lengths - 1`` of layer ``layer_idx`` in place, then attended
    over; returns ``(out, k_pages, v_pages)``. Without them it only attends
    and returns ``out``. ``alibi_slopes``: ``[Hq]`` floats, ``slope·(pos -
    (length - 1))`` added after softcap. Counts kernel launches in
    ``paged_attention.launches``.
    """
    if q.ndim != 3:
        raise ValueError(f"q must be [B, Hq, D], got {tuple(q.shape)}")
    B, Hq, D = q.shape
    if k_pages.ndim != 5 or k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError(f"pools must be matching [P, L, Hk, page, D], got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    P, L, Hk, page, D2 = k_pages.shape
    if D2 != D or Hq % Hk or Hq // Hk > _MAX_GROUPS:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool {tuple(k_pages.shape)} "
                         f"(at most {_MAX_GROUPS} q heads per kv head)")
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} not in (32, 64, 128)")
    if page % _PAGE_MULTIPLE:
        raise ValueError(f"page_size {page} must be a multiple of {_PAGE_MULTIPLE}")
    if k_pages.dtype not in KV_KINDS:
        raise TypeError(f"pool dtype {k_pages.dtype} not in {list(KV_KINDS)}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged attention takes bf16 q, got {q.dtype}")
    if page_tables.ndim != 2 or page_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} and page_tables "
                         f"{tuple(page_tables.shape)} must be [B] and [B, max_pages]")
    layer_idx = int(layer_idx)
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer_idx {layer_idx} outside the pool's {L} layers")
    append = new_k is not None
    dev = q.device
    if not (k_pages.device == v_pages.device == dev
            and (not append or new_k.device == new_v.device == dev)):
        raise ValueError("q, the pools and the new token must be on one device")
    scale = scale if scale is not None else D ** -0.5
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    tables = page_tables.to(device=dev, dtype=torch.int32).contiguous()
    if append:
        new_k = new_k.to(torch.bfloat16).reshape(B, Hk, D).contiguous()
        new_v = new_v.to(torch.bfloat16).reshape(B, Hk, D).contiguous()
    alibi = alibi_slopes_tensor(alibi_slopes, Hq, dev)
    if q.is_cuda:
        if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
            raise ValueError("the pools must be contiguous")
        out = _launch(q.contiguous(), k_pages, v_pages, lengths, tables, layer_idx,
                      new_k, new_v, scale, kv_scale, window, softcap, alibi)
    else:
        out = paged_attention_plain(q, k_pages, v_pages, lengths, tables, layer_idx,
                                    new_k=new_k, new_v=new_v, scale=scale,
                                    kv_scale=kv_scale, window=window, softcap=softcap,
                                    alibi=alibi)
    return (out, k_pages, v_pages) if append else out


paged_attention.launches = 0
