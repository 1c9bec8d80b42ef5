"""Attention: golden reference, single-token decode, and dispatch
(counterpart of ``llm_fp8_tpu/ops/attention.py``).

``attention_ref`` and ``decode_attention`` are plain XLA compositions in the
JAX package, so plain PyTorch is their faithful port. ``attention`` sends
Sq == 1 to ``decode_attention`` and everything else to K3 (the flash kernel)
on a CUDA tensor or to ``attention_ref`` on a CPU tensor.

Segment ids (``q_segment_ids [B, Sq]``, ``kv_segment_ids [B, Sk]``, the
packed-varlen mask of ``ops/varlen.py::pack_sequences``) are taken by
``attention_ref`` and K3, not by ``attention``, as in the JAX package: a
position attends only to keys of its own id (0, the packer's padding, is an
id like any other). ``decode_attention(num_splits=N)`` cuts the cache into N
chunks whose partial attentions merge by their log-sum-exps
(``ops/split_kv.py::combine_partials``); ``"auto"`` resolves through
``split_kv.auto_num_splits``, which gives 1 unless told the core count.

ALiBi (``alibi_slopes``, ``[Hq]`` or ``[B, Hq]``) adds ``-slope·|q_pos -
k_pos|`` on absolute positions after softcap; attention dropout
(``dropout_p``, ``dropout_seed``) drops softmax weights by the stateless
counter hash of ``kernels/_common.py::dropout_keep_mask`` and scales the
survivors by ``1/(1 - p)``, so the golden and K3/K6 drop the same entries.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..kernels._common import alibi_bias, alibi_slopes_tensor, dropout_keep
from ..kernels.flash_attention import flash_attention

__all__ = ["attention_ref", "decode_attention", "attention", "alibi_slopes_list",
           "default_alibi_slopes"]


def alibi_slopes_list(nheads: int) -> list:
    """The ALiBi slope schedule (Press et al.) as Python floats: head i of n
    gets ``2^(-8(i+1)/n)`` for a power-of-two n; other head counts take the
    slopes of the power of two below and every other slope of the one
    above (the published interleaving, as Baichuan-13B's 40 heads use)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(nheads).is_integer():
        return pow2_slopes(nheads)
    closest = 2 ** math.floor(math.log2(nheads))
    return pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: nheads - closest]


@functools.lru_cache(maxsize=None)
def default_alibi_slopes(nheads: int, device=None) -> torch.Tensor:
    """:func:`alibi_slopes_list` as a float32 ``[nheads]`` tensor on
    ``device``, built once per head count and device (a decode step reads it
    without a host-to-device copy, as a captured CUDA graph must)."""
    return torch.tensor(alibi_slopes_list(nheads), dtype=torch.float32,
                        device=torch.device(device) if device is not None else None)


def _build_mask(q_len, k_len, causal, window, q_offset, kv_lens, batch, device,
                attention_chunk=None, kv_start=None, q_segment_ids=None,
                kv_segment_ids=None):
    """Boolean mask ``[B or 1, 1, q_len, k_len]``, True = attend. With
    ``q_segment_ids`` a query attends only to keys of its own id."""
    q_offset = torch.as_tensor(q_offset, dtype=torch.int64, device=device).reshape(-1)
    q_pos = (q_offset[:, None] + torch.arange(q_len, device=device)[None, :])[:, :, None]
    k_pos = torch.arange(k_len, device=device)[None, None, :]
    mask = torch.ones((1, q_len, k_len), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if attention_chunk is not None:
        start = torch.div(q_pos, attention_chunk, rounding_mode="floor") * attention_chunk
        mask = mask & (k_pos >= start) & (k_pos < start + attention_chunk)
    mask = mask[:, None]
    if kv_lens is not None:
        mask = mask & (k_pos < kv_lens.to(device).long()[:, None, None])[:, None]
    if kv_start is not None:
        mask = mask & (k_pos >= kv_start.to(device).long()[:, None, None])[:, None]
    if q_segment_ids is not None:
        qs = torch.as_tensor(q_segment_ids, device=device).long()
        ks = torch.as_tensor(kv_segment_ids, device=device).long()
        mask = mask & (qs[:, None, :, None] == ks[:, None, None, :])
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, scale: Optional[float] = None,
                  q_offset=0, kv_lens: Optional[torch.Tensor] = None,
                  q_segment_ids=None, kv_segment_ids=None,
                  attention_chunk: Optional[int] = None,
                  kv_start: Optional[torch.Tensor] = None, alibi_slopes=None,
                  dropout_p: float = 0.0, dropout_seed=0):
    """Golden attention in float32. q ``[B, Sq, Hq, D]``, k/v ``[B, Sk, Hk, D]``
    (bshd); returns ``[B, Sq, Hq, D]`` in q's dtype. A row with no live key
    gives zeros."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if g > 1:
        kf = kf.repeat_interleave(g, dim=2)
        vf = vf.repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    q_off = torch.as_tensor(q_offset, dtype=torch.int64, device=q.device).reshape(-1).expand(B)
    if alibi_slopes is not None:
        logits = logits + alibi_bias(alibi_slopes_tensor(alibi_slopes, Hq, q.device, batch=B),
                                     q_off, Sq, Sk)
    mask = _build_mask(Sq, Sk, causal, window, q_offset, kv_lens, B, q.device,
                       attention_chunk, kv_start, q_segment_ids, kv_segment_ids)
    logits = torch.where(mask, logits, torch.full_like(logits, -float("inf")))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, torch.zeros_like(probs))
    if dropout_p > 0.0:
        keep = dropout_keep(dropout_seed, dropout_p, q_off, B, Hq, Sq, Sk)
        probs = torch.where(keep, probs, torch.zeros_like(probs)) / (1.0 - dropout_p)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


def decode_attention(q, k, v, *, scale: Optional[float] = None,
                     kv_lens: Optional[torch.Tensor] = None, window: Optional[int] = None,
                     softcap: Optional[float] = None, q_offset=0,
                     attention_chunk: Optional[int] = None,
                     kv_start: Optional[torch.Tensor] = None, alibi_slopes=None,
                     num_splits=1):
    """Single-token decode attention, GQA-grouped, float32. ``num_splits``:
    an integer that divides S cuts the cache into that many chunks merged by
    LSE (:func:`_decode_attention_split`); ``"auto"`` takes
    :func:`..ops.split_kv.auto_num_splits` (1 unless a core count is given)
    and falls back to 1 where its choice does not divide S."""
    B, Sq, Hq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode_attention takes one query position, got {Sq}")
    S, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    scale = scale if scale is not None else D ** -0.5
    if num_splits == "auto":
        from .split_kv import auto_num_splits

        num_splits = auto_num_splits(B, Hk, S)
        if S % num_splits:
            num_splits = 1
    elif num_splits > 1 and S % num_splits:
        raise ValueError(f"num_splits={num_splits} must divide the KV length S={S}; "
                         "pass num_splits='auto' for a divisibility-safe choice")
    if num_splits > 1:
        return _decode_attention_split(q, k, v, int(num_splits), scale=scale, kv_lens=kv_lens,
                                       window=window, softcap=softcap, q_offset=q_offset,
                                       alibi_slopes=alibi_slopes,
                                       attention_chunk=attention_chunk, kv_start=kv_start)
    qg = (q.float() * scale).reshape(B, Hk, g, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)
    q_pos = torch.as_tensor(q_offset, dtype=torch.int64, device=q.device).reshape(-1).expand(B)
    if alibi_slopes is not None:
        s = s + alibi_bias(alibi_slopes_tensor(alibi_slopes, Hq, q.device, batch=B), q_pos, 1,
                           S).reshape(B, Hk, g, S)
    mask = _decode_mask(k_pos[None, :], q_pos[:, None], kv_lens, kv_start, window,
                        attention_chunk)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -float("inf")))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _decode_mask(k_pos, q_pos, kv_lens, kv_start, window, attention_chunk):
    """The decode step's live keys: ``k_pos`` absolute key positions and
    ``q_pos`` the ``[B]`` query positions, broadcast against each other
    (``[B, 1]`` against ``[S]``, or ``[B, 1, 1]`` against ``[N, C]``)."""
    def per_row(t):
        return t.to(q_pos.device).long().reshape(q_pos.shape)

    mask = k_pos <= q_pos
    if kv_lens is not None:
        mask = mask & (k_pos < per_row(kv_lens))
    if kv_start is not None:
        mask = mask & (k_pos >= per_row(kv_start))
    if window is not None:
        mask = mask & (k_pos > q_pos - window)
    if attention_chunk is not None:
        mask = mask & (k_pos >= torch.div(q_pos, attention_chunk, rounding_mode="floor")
                       * attention_chunk)
    return mask


def _decode_attention_split(q, k, v, num_splits: int, *, scale: float, kv_lens, window,
                            softcap, q_offset, alibi_slopes, attention_chunk, kv_start=None):
    """Decode attention as ``num_splits`` KV-chunk partials merged by
    :func:`..ops.split_kv.combine_partials` (JAX's ``_decode_attention_split``,
    in XLA there): per chunk the max, the weights, the normalized partial
    output and its LSE (-inf for a chunk with no live key)."""
    from .split_kv import combine_partials

    B, _, Hq, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    N, C = num_splits, S // num_splits
    kc = k.float().reshape(B, N, C, Hk, D)
    vc = v.float().reshape(B, N, C, Hk, D)
    qg = (q.float() * scale).reshape(B, Hk, g, D)
    s = torch.einsum("bhgd,bnchd->bnhgc", qg, kc)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = (torch.arange(N, device=q.device) * C)[:, None] + torch.arange(C, device=q.device)
    q_pos = torch.as_tensor(q_offset, dtype=torch.int64, device=q.device).reshape(-1).expand(B)
    if alibi_slopes is not None:
        slopes = alibi_slopes_tensor(alibi_slopes, Hq, q.device, batch=B)
        dist = (q_pos[:, None, None] - k_pos[None]).abs().float()  # [B, N, C]
        s = s - slopes.reshape(B, 1, Hk, g, 1) * dist[:, :, None, None, :]
    mask = _decode_mask(k_pos[None], q_pos[:, None, None], kv_lens, kv_start, window,
                        attention_chunk)
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, -float("inf")))
    m = s.amax(dim=-1)  # [B, N, Hk, g]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), torch.zeros_like(s))
    denom = w.sum(dim=-1)
    o = torch.einsum("bnhgc,bnchd->bnhgd", w, vc)
    o = o / torch.where(denom == 0.0, torch.ones_like(denom), denom)[..., None]
    lse = torch.where(denom > 0.0, m_safe + torch.log(denom.clamp_min(1e-37)),
                      torch.full_like(denom, -float("inf")))
    outs = o.permute(1, 0, 2, 3, 4).reshape(N, B, 1, Hq, D)
    lses = lse.permute(1, 0, 2, 3).reshape(N, B, 1, Hq)
    return combine_partials(outs, lses).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              q_offset=0, kv_lens: Optional[torch.Tensor] = None,
              attention_chunk: Optional[int] = None,
              kv_start: Optional[torch.Tensor] = None, alibi_slopes=None,
              dropout_p: float = 0.0, dropout_seed=0, cp_group=None):
    """Public attention entry: :func:`decode_attention` for Sq == 1 without
    dropout, K3 (the flash kernel) on a CUDA tensor, :func:`attention_ref`
    on a CPU tensor.

    ``cp_group``: context parallelism over that process group (JAX's
    ``cp_axis`` island). Every rank of the group holds the whole sequence;
    q, k and v are cut to this rank's chunk, the ring of
    ``parallel/ring_attention.py`` runs, and the output is gathered back
    along the sequence. The cut's backward all-gathers and the gather's
    keeps this rank's slice, so gradients come out whole and equal on the
    group's ranks (``parallel/collectives.py``). Causal or full attention
    with window, softcap and ragged ``kv_lens``; dropout and ALiBi raise,
    as in JAX."""
    if cp_group is not None:
        return _cp_attention(q, k, v, cp_group, causal=causal, window=window, softcap=softcap,
                             scale=scale, q_offset=q_offset, kv_lens=kv_lens,
                             attention_chunk=attention_chunk, kv_start=kv_start,
                             alibi_slopes=alibi_slopes, dropout_p=dropout_p)
    if q.shape[1] == 1 and causal and dropout_p == 0.0:
        return decode_attention(q, k, v, scale=scale, kv_lens=kv_lens, window=window,
                                softcap=softcap, q_offset=q_offset,
                                attention_chunk=attention_chunk, kv_start=kv_start,
                                alibi_slopes=alibi_slopes, num_splits="auto")
    if q.is_cuda:
        if kv_start is not None:
            raise NotImplementedError("kv_start is a decode-path feature")
        return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               scale=scale, q_offset=q_offset, kv_lens=kv_lens,
                               alibi_slopes=alibi_slopes, attention_chunk=attention_chunk,
                               dropout_p=dropout_p, dropout_seed=dropout_seed)
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                         scale=scale, q_offset=q_offset, kv_lens=kv_lens,
                         attention_chunk=attention_chunk, kv_start=kv_start,
                         alibi_slopes=alibi_slopes, dropout_p=dropout_p,
                         dropout_seed=dropout_seed)


def _cp_attention(q, k, v, group, *, causal, window, softcap, scale, q_offset, kv_lens,
                  attention_chunk, kv_start, alibi_slopes, dropout_p):
    from ..parallel.collectives import seq_chunk, seq_gather
    from ..parallel.ring_attention import ring_attention

    if dropout_p != 0.0 or alibi_slopes is not None:
        raise NotImplementedError("context parallelism supports window/softcap/ragged-kv_lens "
                                  "attention but not dropout or ALiBi")
    if attention_chunk is not None or kv_start is not None or not (
            isinstance(q_offset, int) and q_offset == 0) or q.shape[1] != k.shape[1]:
        raise NotImplementedError("context parallelism runs self-attention over the whole "
                                  "sequence: no q_offset, kv_start, chunk or cache")
    qc, kc, vc = (seq_chunk(t, 1, group) for t in (q, k, v))
    out = ring_attention(qc, kc, vc, group=group, causal=causal, scale=scale, window=window,
                         softcap=softcap, kv_lens=kv_lens)
    return seq_gather(out, 1, group)
