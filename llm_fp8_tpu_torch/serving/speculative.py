"""Speculative decoding: draft-model proposal + target-model verification
(counterpart of ``llm_fp8_tpu/serving/speculative.py``).

A small draft model proposes ``gamma`` tokens autoregressively; the target
model scores all proposals in ONE forward (a ``gamma + 1``-token block
against its cache; K3 on the card).

* **greedy** (``temperature=0``): the longest prefix agreeing with the
  target's argmax is accepted: the output is that of plain greedy decoding
  of the target model.
* **sampled** (``temperature>0``, optional top-k/top-p): rejection-sampling
  verification (Leviathan et al.): proposal ``x_i ~ q_i`` is accepted with
  probability ``min(1, p_i(x_i) / q_i(x_i))``; on the first rejection the
  correction token is drawn from ``norm(max(p_i - q_i, 0))``, and when every
  proposal survives the bonus token is drawn from ``p_{gamma+1}``. Both p
  and q are the filtered (top-k/top-p, tempered) distributions, so each
  committed token is distributed as the target's own filtered distribution.

:func:`spec_verify` is host numpy math with a ``np.random.Generator``, as in
the JAX package, so both draw the same tokens from the same generator.
Cache rewind is free: acceptance sets the logical length back; stale rows
past it are masked by ``kv_lens`` and overwritten by later writes.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import forward, init_kv_cache
from ..ops.sampling import filtered_probs, greedy
from ..utils.backend import resolve_device

__all__ = ["SpeculativeDecoder", "spec_verify"]


def spec_verify(
    proposals: np.ndarray,  # [gamma] int: the draft's sampled tokens
    q_probs: np.ndarray,  # [gamma, V]: the draft's distribution at each position
    p_probs: np.ndarray,  # [gamma+1, V]: the target's distribution at each position
    rng: np.random.Generator,
) -> Tuple[List[int], int]:
    """Rejection-sampling verification (host math, model-agnostic).

    Returns ``(committed_tokens, n_accept)``: the accepted prefix plus one
    more token (the residual-sampled correction on rejection, or the bonus
    token from ``p_probs[gamma]`` when everything is accepted).
    """
    gamma, V = q_probs.shape
    out: List[int] = []
    for i in range(gamma):
        x = int(proposals[i])
        q = float(q_probs[i, x])
        p = float(p_probs[i, x])
        if q <= 0.0:
            # The draft proposed a token it gave no mass (numerical noise):
            # a rejection.
            accept = False
        else:
            accept = rng.random() < min(1.0, p / q)
        if accept:
            out.append(x)
            continue
        residual = np.maximum(p_probs[i] - q_probs[i], 0.0)
        total = residual.sum()
        if total <= 0.0:
            # p == q numerically: any sample from p is correct.
            residual, total = p_probs[i].copy(), p_probs[i].sum()
        out.append(int(rng.choice(V, p=residual / total)))
        return out, i
    bonus = p_probs[gamma]
    out.append(int(rng.choice(V, p=bonus / bonus.sum())))
    return out, gamma


class SpeculativeDecoder:
    """Speculative decoding of one sequence for a (target, draft) pair.

    ``temperature == 0`` (default): greedy-exact verification;
    ``temperature > 0`` (optional ``top_k``/``top_p``): rejection sampling
    that keeps the target's filtered sampling distribution. Runs on ``cuda``
    unless ``device`` is given.
    """

    def __init__(self, target_params: Dict, target_cfg: ModelConfig, draft_params: Dict,
                 draft_cfg: ModelConfig, *, gamma: int = 4, max_seq_len: int = 2048,
                 kv_dtype=torch.bfloat16, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, device=None):
        if target_cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.gamma = gamma
        self.max_seq_len = max_seq_len
        self.kv_dtype = kv_dtype
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.accepted_histogram: List[int] = []

    def _logits(self, which, cache, tokens, start: int, end: int):
        params, cfg = (self.tp, self.tcfg) if which == "t" else (self.dp, self.dcfg)
        tokens = torch.as_tensor(np.asarray(tokens, np.int32), device=self.device)[None]
        logits, _ = forward(params, tokens, cfg, cache=cache, start_pos=start,
                            kv_lens=torch.tensor([end], dtype=torch.int32, device=self.device))
        return logits[0]

    def _argmax(self, which, cache, tokens, start, end) -> np.ndarray:
        return greedy(self._logits(which, cache, tokens, start, end)).cpu().numpy()

    def _probs(self, which, cache, tokens, start, end) -> np.ndarray:
        """The filtered sampling distribution at each position, float64."""
        probs = filtered_probs(self._logits(which, cache, tokens, start, end),
                               temperature=self.temperature, top_k=self.top_k, top_p=self.top_p)
        p = probs.double().cpu().numpy()
        return p / p.sum(-1, keepdims=True)

    def _caches(self):
        return (init_kv_cache(self.tcfg, 1, self.max_seq_len, dtype=self.kv_dtype,
                              device=self.device),
                init_kv_cache(self.dcfg, 1, self.max_seq_len, dtype=self.kv_dtype,
                              device=self.device))

    def generate(self, prompt: np.ndarray, max_new_tokens: int) -> List[int]:
        """Generation with draft speculation. Returns the new tokens only."""
        if self.temperature > 0.0:
            return self._generate_sampled(prompt, max_new_tokens)
        return self._generate_greedy(prompt, max_new_tokens)

    def _generate_sampled(self, prompt: np.ndarray, max_new_tokens: int) -> List[int]:
        prompt = np.asarray(prompt, np.int32)
        n0 = len(prompt)
        t_cache, d_cache = self._caches()
        first = self._probs("t", t_cache, prompt, 0, n0)[n0 - 1]
        self._logits("d", d_cache, prompt, 0, n0)
        out: List[int] = [int(self._rng.choice(len(first), p=first / first.sum()))]
        n = n0 + 1
        d_len = n0  # committed tokens the draft cache has ingested
        self.accepted_histogram = []
        while len(out) < max_new_tokens:
            gamma = min(self.gamma, max_new_tokens - len(out), self.max_seq_len - n - 1)
            if gamma <= 0:
                break
            cur = np.asarray((list(prompt) + out)[d_len:n], np.int32)
            pos = d_len
            proposals: List[int] = []
            q_rows: List[np.ndarray] = []
            for _ in range(gamma):
                q = self._probs("d", d_cache, cur, pos, pos + len(cur))[len(cur) - 1]
                nxt = int(self._rng.choice(len(q), p=q))
                pos += len(cur)
                proposals.append(nxt)
                q_rows.append(q)
                cur = np.asarray([nxt], np.int32)
            d_len = pos
            block = np.asarray([out[-1]] + proposals, np.int32)
            p_rows = self._probs("t", t_cache, block, n - 1, n - 1 + len(block))
            committed, n_accept = spec_verify(np.asarray(proposals), np.stack(q_rows), p_rows,
                                              self._rng)
            out.extend(committed)
            self.accepted_histogram.append(n_accept)
            n = n0 + len(out)
            # Only n-1 tokens are valid draft context (the last committed
            # token has not been fed to the draft yet).
            d_len = min(d_len, n - 1)
        return out[:max_new_tokens]

    def _generate_greedy(self, prompt: np.ndarray, max_new_tokens: int) -> List[int]:
        prompt = np.asarray(prompt, np.int32)
        n0 = len(prompt)
        t_cache, d_cache = self._caches()
        out: List[int] = [int(self._argmax("t", t_cache, prompt, 0, n0)[n0 - 1])]
        self._logits("d", d_cache, prompt, 0, n0)
        n = n0 + 1  # committed length (prompt + accepted)
        d_len = n0
        self.accepted_histogram = []
        while len(out) < max_new_tokens:
            gamma = min(self.gamma, max_new_tokens - len(out), self.max_seq_len - n - 1)
            if gamma <= 0:
                break
            # The draft's cache may lag: feed what it has not seen (d_len ..
            # n-1), then its own proposals.
            cur = np.asarray((list(prompt) + out)[d_len:n], np.int32)
            pos = d_len
            proposals: List[int] = []
            for _ in range(gamma):
                nxt = int(self._argmax("d", d_cache, cur, pos, pos + len(cur))[len(cur) - 1])
                pos += len(cur)
                proposals.append(nxt)
                cur = np.asarray([nxt], np.int32)
            d_len = pos
            # The target scores [last committed] + the proposals (positions
            # n-1 .. n+gamma-1): its argmax for positions n .. n+gamma.
            block = np.asarray([out[-1]] + proposals, np.int32)
            targets = self._argmax("t", t_cache, block, n - 1, n - 1 + len(block))
            n_accept = 0
            for i in range(gamma):
                if int(targets[i]) != proposals[i]:
                    break
                n_accept += 1
            out.extend(proposals[:n_accept])
            if len(out) < max_new_tokens:
                out.append(int(targets[n_accept]))
            self.accepted_histogram.append(n_accept)
            n = n0 + len(out)
            d_len = min(d_len, n - 1)
        return out[:max_new_tokens]
