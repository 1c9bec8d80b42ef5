"""Speculative decoding inside the continuous-batching engine (counterpart
of ``llm_fp8_tpu/serving/spec_engine.py``). Every active slot speculates in
the same round:

* **draft lane**: a second cache (bf16, one slot per engine slot) holds the
  draft model's K/V; ``gamma`` batched single-token feeds propose tokens for
  every slot, plus one ingest-only feed so both caches cover the same
  positions. The draft's attention is the plain ``decode_attention``.
* **families**: ``forward_fn`` and ``draft_forward_fn`` (default: the Llama
  family's ``forward``) serve any pair with the cache signature and one
  vocabulary, as the JAX engine's hooks: a GPT-2/NeoX target runs the slot
  engine's KVCache path (``Engine(forward_fn=...)``), and a float32-compute
  zoo draft (GPT-2, NeoX) gets one float32 copy of its head at construction
  (``models/zoo.py::with_f32_head``; a Gemma-2, MoE or MLA draft computes
  in bf16 and gets none), so the captured round reads only device tensors.
* **verify lane**: ONE target forward over the ``[slots, gamma+1]`` block
  (``[last_committed, p_1..p_gamma]``) at each slot's own ``start_pos``;
  ``kv_lens`` masks the ragged batch (K3 over the dequantized cache on the
  card).
* **accept/reject on the device**: greedy mode commits the longest
  argmax-agreeing prefix (the tokens of plain greedy decoding); sampled mode
  runs the vectorized Leviathan test ``u * q(x) < p(x)`` per slot with a
  draw from the residual (:func:`leviathan_accept`), which keeps the
  target's filtered sampling distribution.

Cache rewind is free: acceptance only moves each slot's logical length;
rows past it are masked by ``kv_lens`` and overwritten by the next round.

Rounds chain on the device: ``decode_burst // 2`` rounds a host step. On
the card one round is captured once as a CUDA graph over static tokens and
lengths (``cuda_graph.py``), and a burst of rounds is that many replays and
one read-back (the counterpart of the rounds' ``lax.scan``); in sampled mode
the engine's generator is registered with the graph, so each replay draws
anew. On the CPU the rounds run as a Python loop of the same round. The host
truncates each slot at its stop after the burst.

``mesh`` (the Llama family, as :class:`Engine`'s): the target is split over
``tp`` and the slots are cut over the data axes ``(dp, fsdp)`` by
``Engine._mesh_shard``; the draft is split over the same tp group with its
own layout, or kept whole on every rank where ``tp`` does not divide its kv
heads (JAX's ``adapt_spec`` replicates the draft cache's heads there). A
rank's draft cache holds its data group's slots and its kv heads. Both
prefills run on the data group that owns the slot. A round steps the rank's
rows (the draft's feeds and the verify block with ``tp=``, acceptance on
those rows) and all-gathers its outputs over the data group before the
full-width static buffers take them. Every random draw is made for the
whole batch and cut to the rank's rows, so every rank of a tp group draws
what its peers draw, slots of different data groups draw different numbers,
and a mesh run draws what the mesh-less engine draws. On the card the round
stays one CUDA graph with both models' and the data group's collectives
inside.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import KVCache, forward, init_kv_cache
from ..models.zoo import with_f32_head
from ..ops.sampling import filtered_logits, filtered_probs, greedy
from ..utils.backend import resolve_device
from .cuda_graph import StepGraph
from .engine import Engine, EngineConfig, Request

__all__ = ["SpecEngine", "leviathan_accept", "draw"]


def _uniform(shape, generator: Optional[torch.Generator], device, rows=None) -> torch.Tensor:
    """``U[0, 1)`` of ``shape`` from ``generator``. ``rows = (B, s0)``: rows
    ``s0 .. s0 + shape[0]`` of a draw for all ``B`` rows, so a data group's
    slots take the whole batch's numbers."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    B, s0 = rows
    return torch.rand((B, *shape[1:]), generator=generator, device=device)[s0:s0 + shape[0]]


def draw(probs: torch.Tensor, generator: Optional[torch.Generator], rows=None) -> torch.Tensor:
    """One categorical sample per row of ``probs [..., V]`` (unnormalized
    weights are fine): ``argmax(probs / E)`` with ``E ~ Exp(1)`` drawn from
    ``generator``, no host sync (it runs inside a captured round). Returns
    int32 ``[...]``. ``rows``: as :func:`_uniform`'s, for ``probs [b, V]``."""
    u = _uniform(probs.shape, generator, probs.device, rows)
    e = -torch.log(u.clamp_min(torch.finfo(torch.float32).tiny))
    return torch.argmax(probs.float() / e, dim=-1).to(torch.int32)


def leviathan_accept(proposals: torch.Tensor, q_probs: torch.Tensor, p_probs: torch.Tensor,
                     generator: Optional[torch.Generator],
                     rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vectorized rejection test of one round (JAX ``_spec_round``'s
    sampled branch): ``proposals [B, g]`` drawn from ``q_probs [B, g, V]``,
    target ``p_probs [B, g+1, V]``. Returns ``(n_accept [B], correction
    [B])``: the accepted prefix length and the token after it, drawn from
    ``max(p - q, 0)`` at the first rejection (``p`` itself where that is
    zero) or from ``p`` at ``g`` when everything was accepted. ``rows``: as
    :func:`_uniform`'s (the batch's rows of a data group)."""
    B, g = proposals.shape
    idx = proposals.long()[..., None]
    qx = torch.gather(q_probs, -1, idx)[..., 0]
    px = torch.gather(p_probs[:, :g], -1, idx)[..., 0]
    u = _uniform((B, g), generator, proposals.device, rows)
    # u*q < p  <=>  u < min(1, p/q); q <= 0 (a numerical-noise proposal)
    # rejects, as spec_verify does.
    accept = (qx > 0.0) & (u * qx < px)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    q_ext = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
    at = n_acc.long()[:, None, None].expand(B, 1, p_probs.shape[-1])
    p_row = torch.gather(p_probs, 1, at)[:, 0]
    q_row = torch.gather(q_ext, 1, at)[:, 0]
    residual = torch.clamp(p_row - q_row, min=0.0)
    residual = torch.where(residual.sum(-1, keepdim=True) > 0.0, residual, p_row)
    return n_acc.to(torch.int32), draw(residual, generator, rows)


class SpecEngine(Engine):
    """Continuous-batching engine with a draft-model speculative lane.

    ``temperature == 0`` (default): greedy-exact, the committed tokens are
    those of :class:`Engine`'s greedy decoding of the target alone.
    ``temperature > 0`` (+ optional ``top_k``/``top_p``): rejection-sampling
    verification; each committed token is distributed as the target's
    filtered distribution. The sampling config is the engine's; per-request
    ``SamplingParams`` govern stopping only. Runs on ``cuda`` unless
    ``device`` is given. ``forward_fn``/``draft_forward_fn``: the target's
    and the draft's family forwards (default: the Llama family's).
    ``mesh``: serve over a ``DeviceMesh`` (module docstring); another
    family's target or draft raises ``NotImplementedError`` there above one
    rank.
    """

    _use_arena = False  # the verify lane feeds gamma+1 tokens: the KVCache path
    _SPEC_BURST_BUCKETS = (16, 8, 4, 2)

    def __init__(self, params: Dict[str, Any], model_cfg: ModelConfig,
                 draft_params: Dict[str, Any], draft_cfg: ModelConfig,
                 engine_cfg: EngineConfig = EngineConfig(), *, gamma: int = 4,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
                 eos_token_id: Optional[int] = None, device=None, seed: int = 0,
                 forward_fn=None, draft_forward_fn=None, mesh=None):
        if model_cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self._dforward = draft_forward_fn if draft_forward_fn is not None else forward
        if mesh is not None and self._dforward is not forward and mesh.mesh.numel() > 1:
            raise NotImplementedError(
                "SpecEngine(mesh=) over more than one rank serves the Llama family's draft "
                "only; other families under a mesh are not ported yet (ROADMAP.md, Queue 1: "
                "\"The other families over a mesh\")")
        dev = resolve_device(device)
        super().__init__(params, model_cfg, engine_cfg, eos_token_id=eos_token_id,
                         device=dev, generator=torch.Generator(device=dev).manual_seed(seed),
                         forward_fn=forward_fn, mesh=mesh)
        #: The draft's tp rank (None: no mesh, or the draft whole on every rank).
        self.dtp = None
        if self.tp is not None and self._dforward is forward:
            draft_params, draft_cfg = self._mesh_shard_draft(draft_params, draft_cfg)
        self.dparams = (draft_params if self._dforward is forward
                        else with_f32_head(draft_params))
        self.dcfg = draft_cfg
        self.gamma = int(gamma)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        B, S = self.ecfg.max_slots, self.ecfg.max_seq_len
        # The draft cache in bf16: the draft is small, and quantizing it buys
        # nothing once the target dominates the memory traffic.
        self.dcache: KVCache = init_kv_cache(draft_cfg, self._nslots, S, dtype=torch.bfloat16,
                                             device=dev)
        # The round's static outputs (the tokens and lengths are the
        # engine's ``_toks``/``_lens``; ``_row`` picks the output row).
        R, g = max(self._SPEC_BURST_BUCKETS), self.gamma
        self._committed = torch.zeros((R, B, g + 1), dtype=torch.int32, device=dev)
        self._n_commit = torch.zeros((R, B), dtype=torch.int32, device=dev)
        self.round_graph = StepGraph(
            self._graph_round, (self._toks, self._lens, self._row, self._committed,
                                self._n_commit),
            generator=self._generator if self.temperature > 0.0 else None)
        # Telemetry: recent per-round accepted counts (capped) and lifetime
        # totals.
        self.accepted_histogram: deque = deque(maxlen=4096)
        self.accepted_total = 0
        self.rounds_total = 0

    def _mesh_shard_draft(self, params, cfg: ModelConfig):
        """The draft's shard and config over the target's tp group (a tree of
        ``shard_params`` gathered first), or the whole draft where ``tp`` does
        not divide its kv heads."""
        from ..parallel.sharding import gather_tree
        from ..parallel.tensor import tp_layout, tp_shard

        params = gather_tree(params)
        layout = tp_layout(params, cfg, self.tp.layout.size)
        if not layout.heads:
            return params, cfg
        params, cfg, self.dtp = tp_shard(params, cfg, layout.size, self.tp.rank, self.tp.group,
                                         layout)
        return params, cfg

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------

    def _dtp_kw(self):
        return {} if self.dtp is None else {"tp": self.dtp}

    def _draft_prefill(self, tokens: torch.Tensor, true_len: torch.Tensor, slot: int):
        """Prefill the draft cache slot with the same prompt (its logits are
        unused: the first committed token comes from the target), on the data
        group holding the slot."""
        owner, row = self._owner(slot)
        if owner != self._data_index:
            return
        bucket = tokens.shape[0]
        one = init_kv_cache(self.dcfg, 1, bucket, dtype=torch.bfloat16, device=self.device)
        _, one = self._dforward(self.dparams, tokens[None, :], self.dcfg, cache=one,
                                start_pos=0, kv_lens=true_len.reshape(1), **self._dtp_kw())
        self.dcache.k[:, row, :bucket] = one.k[:, 0]
        self.dcache.v[:, row, :bucket] = one.v[:, 0]
        self.dcache.lens[row] = true_len

    def _filtered(self, logits):
        return filtered_logits(logits, temperature=self.temperature, top_k=self.top_k,
                               top_p=self.top_p)

    def _verify(self, block: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """The verify lane: one ragged-batch target forward over ``block [b,
        g+1]`` at each row's ``lens``; its logits ``[b, g+1, V]``."""
        logits, _ = self._forward(self.params, block, self.cfg, cache=self.cache,
                                  start_pos=lens, kv_lens=lens + block.shape[1],
                                  **self._tp_kw())
        return logits

    def _spec_round(self, toks: torch.Tensor, lens: torch.Tensor):
        """One speculative round over every slot. Returns ``(committed [B,
        g+1] int32, n_commit [B], new_last [B], new_lens [B])``: position
        ``i`` of ``committed`` is valid iff ``i < n_commit``; ``n_commit =
        n_accept + 1`` (the accepted prefix and the correction or bonus).
        Under a mesh the rank steps its data group's rows, and the outputs
        of every slot are gathered."""
        g = self.gamma
        greedy_mode = self.temperature == 0.0
        rows = None
        if self._data is not None:
            s0 = self._data_index * self._nslots
            rows = (toks.shape[0], s0)
            toks, lens = toks[s0:s0 + self._nslots], lens[s0:s0 + self._nslots]

        # --- draft lane: gamma proposal feeds + 1 ingest-only feed ---
        tok, pos, props, q_rows = toks, lens, [], []
        for _ in range(g + 1):
            logits, _ = self._dforward(self.dparams, tok[:, None], self.dcfg,
                                       cache=self.dcache, start_pos=pos, kv_lens=pos + 1,
                                       **self._dtp_kw())
            logits = logits[:, 0]
            if greedy_mode:
                tok = greedy(logits)
            else:
                q = torch.softmax(self._filtered(logits), dim=-1)
                tok = draw(q, self._generator, rows)
                q_rows.append(q)
            props.append(tok)
            pos = pos + 1
        proposals = torch.stack(props[:g], dim=1)  # the last feed's output is dropped

        # --- verify lane: one ragged-batch target forward ---
        tlogits = self._verify(torch.cat([toks[:, None], proposals], dim=1), lens)
        if greedy_mode:
            targets = greedy(tlogits)
            accept = proposals == targets[:, :g]
            n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
            correction = torch.gather(targets, 1, n_acc.long()[:, None])[:, 0]
        else:
            p_probs = filtered_probs(tlogits, temperature=self.temperature, top_k=self.top_k,
                                     top_p=self.top_p)
            n_acc, correction = leviathan_accept(proposals, torch.stack(q_rows[:g], dim=1),
                                                 p_probs, self._generator, rows)

        idx = torch.arange(g + 1, dtype=torch.int32, device=toks.device)[None, :]
        props_pad = torch.cat([proposals, torch.zeros_like(proposals[:, :1])], dim=1)
        committed = torch.where(idx < n_acc[:, None], props_pad,
                                torch.where(idx == n_acc[:, None], correction[:, None],
                                            torch.zeros_like(props_pad)))
        new_lens = lens + n_acc + 1
        # Keep the caches' lens meaningful (the forwards bumped them past
        # rejected rows); in place, as the captured round writes them.
        self.cache.lens.copy_(new_lens)
        self.dcache.lens.copy_(new_lens)
        out = (committed, n_acc + 1, correction, new_lens)
        if self._data is None:
            return out
        from ..parallel.collectives import all_gather

        return tuple(all_gather(t, 0, self._data) for t in out)

    def _graph_round(self):
        """The round the CUDA graph captures, over the static buffers: its
        outputs go into row ``_row`` of ``_committed``/``_n_commit``, and
        ``_toks``/``_lens`` advance to the new last token and length."""
        committed, n_commit, new_last, new_lens = self._spec_round(self._toks, self._lens)
        self._committed.index_copy_(0, self._row, committed[None])
        self._n_commit.index_copy_(0, self._row, n_commit[None])
        self._row.add_(1)
        self._toks.copy_(new_last)
        self._lens.copy_(new_lens)

    def _replay_rounds(self, toks, lens, rounds: int):
        """``rounds`` replays of the captured round (captured at the first
        call); one read-back."""
        self._toks.copy_(toks)
        self._lens.copy_(lens)
        self._row.zero_()
        if not self.round_graph.captured:
            self.round_graph.capture()
        for _ in range(rounds):
            self.round_graph.replay()
        return (self._committed[:rounds].cpu().numpy(), self._n_commit[:rounds].cpu().numpy(),
                self._toks.cpu().numpy(), self._lens.cpu().numpy())

    def _round_loop(self, toks, lens, rounds: int):
        """``rounds`` eager rounds; read back once."""
        committed, n_commit = [], []
        for _ in range(rounds):
            c, n, toks, lens = self._spec_round(toks, lens)
            committed.append(c)
            n_commit.append(n)
        return (torch.stack(committed).cpu().numpy(), torch.stack(n_commit).cpu().numpy(),
                toks.cpu().numpy(), lens.cpu().numpy())

    def _run_spec_rounds(self, toks, lens, rounds: int):
        """``rounds`` chained rounds: ``(committed [rounds, B, g+1], n_commit
        [rounds, B], new_last [B], new_lens [B])`` on the host. Replays of
        the captured round on the card, the loop on the CPU."""
        if self.device.type == "cuda":
            return self._replay_rounds(toks, lens, rounds)
        return self._round_loop(toks, lens, rounds)

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------

    def _sample_first(self, logits: torch.Tensor) -> int:
        """The first committed token after prefill, drawn with the engine's
        sampling config (the verified stream's own distribution)."""
        if self.temperature == 0.0:
            return int(torch.argmax(logits))
        return int(self._agreed(draw(torch.softmax(self._filtered(logits[None]), dim=-1),
                                     self._generator)[0]))

    def step(self) -> List[Request]:
        """Admit waiting requests (prefilling both caches), then a burst of
        speculative rounds over every active slot."""
        finished: List[Request] = []
        g = self.gamma
        dev = self.device
        for slot in range(self.ecfg.max_slots):
            if not self.waiting or self.slot_req[slot] is not None:
                continue
            req = self.waiting[0]
            if (len(req.prompt) + req.params.max_new_tokens > self.ecfg.max_seq_len
                    or len(req.prompt) > self.ecfg.prefill_buckets[-1]):
                self.waiting.pop(0)
                req.done = True
                req.error = (
                    f"rejected: prompt={len(req.prompt)} + "
                    f"max_new={req.params.max_new_tokens} exceeds arena "
                    f"max_seq_len={self.ecfg.max_seq_len} or largest prefill "
                    f"bucket {self.ecfg.prefill_buckets[-1]}")
                finished.append(req)
                continue
            # A round writes g+1 rows past the committed length: clamp
            # max_new_tokens to keep a full round inside the cache rather
            # than reject what the plain Engine serves.
            spec_room = self.ecfg.max_seq_len - len(req.prompt) - (g + 1)
            if req.params.max_new_tokens > spec_room:
                if spec_room < 1:
                    self.waiting.pop(0)
                    req.done = True
                    req.error = (
                        f"rejected: prompt={len(req.prompt)} leaves no room for a "
                        f"speculative round (gamma={g}) in "
                        f"max_seq_len={self.ecfg.max_seq_len}")
                    finished.append(req)
                    continue
                req.params = dataclasses.replace(req.params, max_new_tokens=spec_room)
                req.error = (f"max_new_tokens clamped to {spec_room} to fit a gamma={g} "
                             "speculative round in the arena")
            self.waiting.pop(0)
            bucket = self._bucket_for(len(req.prompt))
            padded = np.zeros((bucket,), np.int32)
            padded[: len(req.prompt)] = req.prompt
            tokens = torch.as_tensor(padded, device=dev)
            n = torch.tensor(len(req.prompt), dtype=torch.int32, device=dev)
            last_logits = self._run_prefill(tokens, n, slot)
            self._draft_prefill(tokens, n, slot)
            tok = self._sample_first(last_logits)
            req.first_token_time = time.perf_counter()
            req.output.append(tok)
            req.slot = slot
            self.slot_req[slot] = req
            self.slot_lens[slot] = len(req.prompt)
            self.slot_last_tok[slot] = tok
            if self._is_stop(req, tok):
                finished.append(self._retire(slot))

        if any(r is not None for r in self.slot_req):
            rounds = self._spec_rounds()
            committed, n_commit, new_last, new_lens = self._run_spec_rounds(
                torch.as_tensor(self.slot_last_tok, device=dev),
                torch.as_tensor(self.slot_lens, device=dev), rounds)
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                stopped = False
                for r in range(rounds):
                    if stopped:
                        break  # later rounds speculated past a stop: dropped
                    self.accepted_histogram.append(int(n_commit[r, slot]) - 1)
                    self.accepted_total += int(n_commit[r, slot]) - 1
                    self.rounds_total += 1
                    for i in range(int(n_commit[r, slot])):
                        if len(req.output) >= req.params.max_new_tokens:
                            stopped = True
                            break
                        tok = int(committed[r, slot, i])
                        req.output.append(tok)
                        if self._is_stop(req, tok):
                            stopped = True
                            break
                self.slot_lens[slot] = int(new_lens[slot])
                self.slot_last_tok[slot] = int(new_last[slot])
                if stopped or self.slot_lens[slot] + g + 2 >= self.ecfg.max_seq_len:
                    finished.append(self._retire(slot))
        return finished

    def _spec_rounds(self) -> int:
        """Rounds a host step. ``decode_burst`` is a committed-token budget; a
        round commits at least 1 and typically 2-3 tokens, so the round
        budget is ``decode_burst // 2``. A round may grow each slot's cache
        by g+1 rows whatever the host later truncates, so every slot keeps
        headroom for all rounds; the remaining-budget term avoids running far
        past a slot's request. Bucketed (one captured round serves every
        count); at most 2 while requests wait, so freed slots refill."""
        g = self.gamma
        active = [(s, r) for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 1
        n = min(max(1, self.ecfg.decode_burst // 2),
                min(r.params.max_new_tokens - len(r.output) for _, r in active),
                min((self.ecfg.max_seq_len - 2 - int(self.slot_lens[s])) // (g + 1)
                    for s, _ in active))
        if self.waiting:
            n = min(n, 2)
        for b in self._SPEC_BURST_BUCKETS:
            if b <= n:
                return b
        return 1
