"""Attention: golden reference, single-token decode, and dispatch
(counterpart of ``llm_fp8_tpu/ops/attention.py``).

``attention_ref`` and ``decode_attention`` are plain XLA compositions in the
JAX package, so plain PyTorch is their faithful port. ``attention`` sends
Sq == 1 to ``decode_attention`` and everything else to K3 (the flash kernel)
on a CUDA tensor or to ``attention_ref`` on a CPU tensor.

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
                attention_chunk=None, kv_start=None):
    """Boolean mask ``[B or 1, 1, q_len, k_len]``, True = attend."""
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
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, scale: Optional[float] = None,
                  q_offset=0, kv_lens: Optional[torch.Tensor] = None,
                  attention_chunk: Optional[int] = None,
                  kv_start: Optional[torch.Tensor] = None, alibi_slopes=None,
                  dropout_p: float = 0.0, dropout_seed=0):
    """Golden attention in float32. q ``[B, Sq, Hq, D]``, k/v ``[B, Sk, Hk, D]``
    (bshd); returns ``[B, Sq, Hq, D]`` in q's dtype."""
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
                       attention_chunk, kv_start)
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
                     kv_start: Optional[torch.Tensor] = None, alibi_slopes=None):
    """Single-token decode attention, GQA-grouped, float32 (unsplit: the JAX
    ``num_splits`` lever resolves to 1 off multi-core TPUs and is not ported)."""
    B, Sq, Hq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode_attention takes one query position, got {Sq}")
    S, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    scale = scale if scale is not None else D ** -0.5
    qg = (q.float() * scale).reshape(B, Hk, g, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)
    q_pos = torch.as_tensor(q_offset, dtype=torch.int64, device=q.device).reshape(-1).expand(B)
    if alibi_slopes is not None:
        s = s + alibi_bias(alibi_slopes_tensor(alibi_slopes, Hq, q.device, batch=B), q_pos, 1,
                           S).reshape(B, Hk, g, S)
    mask = k_pos[None, :] <= q_pos[:, None]
    if kv_lens is not None:
        mask = mask & (k_pos[None, :] < kv_lens.to(q.device).long()[:, None])
    if kv_start is not None:
        mask = mask & (k_pos[None, :] >= kv_start.to(q.device).long()[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    if attention_chunk is not None:
        mask = mask & (k_pos[None, :] >= torch.div(
            q_pos[:, None], attention_chunk, rounding_mode="floor") * attention_chunk)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, -float("inf")))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              q_offset=0, kv_lens: Optional[torch.Tensor] = None,
              attention_chunk: Optional[int] = None,
              kv_start: Optional[torch.Tensor] = None, alibi_slopes=None,
              dropout_p: float = 0.0, dropout_seed=0):
    """Public attention entry: :func:`decode_attention` for Sq == 1 without
    dropout, K3 (the flash kernel) on a CUDA tensor, :func:`attention_ref`
    on a CPU tensor."""
    if q.shape[1] == 1 and causal and dropout_p == 0.0:
        return decode_attention(q, k, v, scale=scale, kv_lens=kv_lens, window=window,
                                softcap=softcap, q_offset=q_offset,
                                attention_chunk=attention_chunk, kv_start=kv_start,
                                alibi_slopes=alibi_slopes)
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
