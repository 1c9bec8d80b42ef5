"""Causal LM loss (counterpart of ``llm_fp8_tpu/training/losses.py``):
next-token cross entropy with a padding mask, z-loss and label smoothing,
and the chunked form fused with the lm_head projection."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..quant.dot import matmul_f32

__all__ = ["causal_lm_loss", "chunked_causal_lm_loss", "token_count", "IGNORE_INDEX"]

IGNORE_INDEX = -100  # HF convention used by the reference's collator


def _nll(lg: torch.Tensor, labels: torch.Tensor, z_loss: float,
         label_smoothing: float) -> torch.Tensor:
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, labels[..., None])[..., 0]
    nll = lse - picked
    if label_smoothing > 0.0:
        smooth = lse - lg.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    if z_loss > 0.0:
        nll = nll + z_loss * lse.square()
    return nll


def _valid(tokens: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    labels = tokens[:, 1:]
    valid = labels != IGNORE_INDEX
    if mask is not None:
        valid = valid & mask[:, 1:].to(device=tokens.device).bool()
    return valid


def token_count(tokens: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The number of predicted tokens the losses average over (int64, 0-d,
    before the floor of 1)."""
    return _valid(torch.as_tensor(tokens).long(), mask).sum()


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *, z_loss: float = 0.0,
                   label_smoothing: float = 0.0,
                   n_total: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE over ``logits [B, S, V]``: position t predicts token
    t+1; the last position, padded positions and ``IGNORE_INDEX`` labels are
    excluded. Returns ``(mean_loss, total_tokens)``. ``n_total``: the count
    to divide by (a data-parallel world's, summed over its ranks), returned
    as the second value; default this batch's."""
    tokens = tokens.to(logits.device).long()
    valid = _valid(tokens, mask)
    labels = torch.where(valid, tokens[:, 1:], torch.zeros_like(tokens[:, 1:]))
    nll = _nll(logits[:, :-1].float(), labels, z_loss, label_smoothing)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    n = valid.sum().clamp(min=1) if n_total is None else n_total
    return nll.sum() / n, n


def chunked_causal_lm_loss(hidden: torch.Tensor, lm_weight: torch.Tensor,
                           tokens: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                           num_chunks: int = 8, z_loss: float = 0.0,
                           label_smoothing: float = 0.0,
                           n_total: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`causal_lm_loss` fused with the lm_head projection
    (``hidden [B, S, D] @ lm_weight [D, V]``), rows taken in ``num_chunks``
    chunks whose logits are recomputed in the backward
    (``torch.utils.checkpoint``), so the ``[B, S, V]`` float32 logits never
    exist at once. Gradients reach ``hidden`` and ``lm_weight``.
    ``n_total`` as in :func:`causal_lm_loss`."""
    D = hidden.shape[-1]
    tokens = tokens.to(hidden.device).long()
    h = hidden[:, :-1].reshape(-1, D)
    valid = _valid(tokens, mask).reshape(-1)
    labels = torch.where(valid, tokens[:, 1:].reshape(-1), torch.zeros_like(valid, dtype=torch.long))
    pad = (-h.shape[0]) % num_chunks
    if pad:
        h = torch.cat([h, h.new_zeros((pad, D))])
        labels = torch.cat([labels, labels.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    rows = h.shape[0] // num_chunks

    def body(hc, w, lc, vc):
        lg = matmul_f32(hc, w.to(hc.dtype))
        nll = _nll(lg, lc, z_loss, label_smoothing)
        return torch.where(vc, nll, torch.zeros_like(nll)).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(num_chunks):
        sl = slice(i * rows, (i + 1) * rows)
        total = total + checkpoint(body, h[sl], lm_weight, labels[sl], valid[sl],
                                   use_reentrant=False)
    n = valid.sum().clamp(min=1) if n_total is None else n_total
    return total / n, n
