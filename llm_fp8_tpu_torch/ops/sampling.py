"""Token sampling: greedy, temperature, top-k, top-p (counterpart of
``llm_fp8_tpu/ops/sampling.py``). Random draws take an explicit
``torch.Generator`` on the logits' device."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample", "greedy", "filtered_logits", "filtered_probs"]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis; ``[B, V] -> [B]`` int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, torch.full_like(logits, -float("inf")), logits)


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    neg = torch.full_like(sorted_logits, -float("inf"))
    thresh = torch.where(cum <= (1.0 - p), sorted_logits, neg).amax(dim=-1, keepdim=True)
    return torch.where(logits <= thresh, torch.full_like(logits, -float("inf")), logits)


def filtered_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """top-k filter, then temperature, then top-p (the reference's order)."""
    logits = logits.float()
    if top_k > 0:
        logits = _top_k_mask(logits, min(top_k, logits.shape[-1]))
    if temperature != 1.0:
        logits = logits / temperature
    if 0.0 < top_p < 1.0:
        logits = _top_p_mask(logits, top_p)
    return logits


def filtered_probs(logits: torch.Tensor, *, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    return torch.softmax(filtered_logits(logits, temperature=temperature, top_k=top_k,
                                         top_p=top_p), dim=-1)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Sample ids from ``logits [B, V]``; greedy at temperature 0 or top_k 1."""
    if temperature == 0.0 or top_k == 1:
        return greedy(logits)
    probs = filtered_probs(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
