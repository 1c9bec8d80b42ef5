"""Paged continuous-batching engine: block-table KV pool + paged decode (K5).

Counterpart of ``llm_fp8_tpu/serving/paged_engine.py``. The native block
allocator (``serving/block_table.py``) hands out pages of one physical pool
shared by every request and layer; a prompt's K/V is quantized and scattered
into its pages after a cache-less prefill (K3 on the card); each decode step
runs :func:`~..models.llama.forward_paged` (K5 appends and attends) over all
slots at their own positions. Memory is taken per page as sequences are
admitted instead of ``max_slots × max_seq_len`` up front.

Port choices: the pools are ``[P, L, Hk, page, Dh]`` and are updated in
place; the prefill maps only the last prompt position through the lm_head
(the one row the engine reads) instead of the whole bucket.

On the card a decode step is captured once as a CUDA graph over static
tokens, lengths and block tables ``[slots, width]`` (pages are reserved to
``max_new`` at admission, so the tables hold still within a burst); a burst
is that many replays and one read-back, as in the arena engine. On the CPU
a burst is a Python loop of the same step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels.paged_attention import quantize_to_pool
from ..models.config import ModelConfig
from ..models.llama import _lm_head, forward, forward_paged
from ..ops.sampling import greedy
from ..utils.backend import resolve_device, resolve_kv_dtype
from .block_table import BlockAllocator, SequenceTable
from .engine import Request, RequestQueue

__all__ = ["PagedEngineConfig", "PagedEngine"]


@dataclasses.dataclass(frozen=True)
class PagedEngineConfig:
    max_slots: int = 8
    num_pages: int = 256  # physical pool size, the scratch page included
    page_size: int = 128
    max_pages_per_seq: int = 16  # block-table width (max_seq = this × page)
    #: "auto" (e4m3 on an fp8-capable card, bf16 on the CPU), "fp8", "int8",
    #: "bf16" or a torch dtype.
    kv_dtype: Any = "auto"
    kv_scale: float = 1.0
    prefill_buckets: tuple = (128, 256, 512, 1024)
    #: Max greedy decode steps per burst (1 = per-step decode). Safe because
    #: admission reserves pages for prompt + max_new, so block tables are
    #: static across a burst; a stop inside a burst truncates on the host.
    decode_burst: int = 32

    def __post_init__(self):
        for b in self.prefill_buckets:
            if b % self.page_size != 0:
                raise ValueError(
                    f"prefill bucket {b} must be a multiple of page_size "
                    f"{self.page_size} (a bucket smaller than one page would "
                    "silently drop the prompt's K/V)")


class PagedEngine(RequestQueue):
    """Paged-KV engine; params may hold QTensor fp8/int8 weights.

    Runs on ``cuda`` unless ``device`` is given (``device="cpu"`` runs the
    plain versions of the kernels)."""

    def __init__(self, params: Dict[str, Any], model_cfg: ModelConfig,
                 engine_cfg: PagedEngineConfig = PagedEngineConfig(), *,
                 eos_token_id: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = dev = resolve_device(device)
        self.params = params
        self.cfg = model_cfg
        engine_cfg = dataclasses.replace(
            engine_cfg, kv_dtype=resolve_kv_dtype(engine_cfg.kv_dtype, dev))
        self.ecfg = engine_cfg
        self.eos = eos_token_id
        L, Hk, Dh = model_cfg.num_layers, model_cfg.num_kv_heads, model_cfg.head_dim
        P, page = engine_cfg.num_pages, engine_cfg.page_size
        self.k_pages = torch.zeros((P, L, Hk, page, Dh), dtype=engine_cfg.kv_dtype, device=dev)
        self.v_pages = torch.zeros_like(self.k_pages)
        # Physical page P-1 is the scratch sink: inactive decode slots and
        # prefill bucket-tail chunks write there, never to a live page.
        self.scratch_page = P - 1
        self.allocator = BlockAllocator(P - 1, page)

        B = engine_cfg.max_slots
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_tables: List[Optional[SequenceTable]] = [None] * B
        self.slot_lens = np.zeros((B,), np.int32)
        self.slot_last_tok = np.zeros((B,), np.int32)
        self.waiting: List[Request] = []
        self._next_id = 0
        self._generator = generator or torch.Generator(device=dev).manual_seed(0)
        self._init_step_graph(B, model_cfg.vocab_size, dev)
        # The block tables are static within a burst: the graph reads them.
        self._tables = torch.zeros((B, engine_cfg.max_pages_per_seq), dtype=torch.int32,
                                   device=dev)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------

    def _prefill(self, tokens: torch.Tensor, true_len: int):
        """Prompt forward without a cache: the last prompt position's logits
        and the per-layer K/V ``[L, bucket, Hk, Dh]`` for page insertion."""
        hidden, (k, v) = forward(
            self.params, tokens[None, :], self.cfg,
            kv_lens=torch.tensor([true_len], dtype=torch.int32, device=self.device),
            return_kv=True, return_hidden=True)
        return _lm_head(self.params, hidden[0, true_len - 1], self.cfg), k[:, 0], v[:, 0]

    def _insert(self, k_new: torch.Tensor, v_new: torch.Tensor, blocks: List[int]):
        """Quantize prefill K/V ``[L, bucket, Hk, Dh]`` by ``kv_scale`` and
        scatter prompt page i into physical page ``blocks[i]`` in place. The
        bucket's tail pages go to the scratch page (the last one stays
        there, as on the TPU)."""
        page = self.ecfg.page_size
        L, bucket, Hk, Dh = k_new.shape
        n_pages = bucket // page
        ids = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for pool, new in ((self.k_pages, k_new), (self.v_pages, v_new)):
            codes = quantize_to_pool(new, self.ecfg.kv_scale, pool.dtype)
            codes = codes.reshape(L, n_pages, page, Hk, Dh).permute(1, 0, 3, 2, 4)
            pool[ids] = codes[:len(blocks)]
            if len(blocks) < n_pages:
                pool[self.scratch_page] = codes[n_pages - 1]

    def _decode_step(self, toks: torch.Tensor, tables: torch.Tensor, lens: torch.Tensor):
        """One decode step over every slot: ``(logits [B, V], greedy [B])``.
        K5 writes the pools in place (the forward returns the same tensors)."""
        logits, _, _ = forward_paged(
            self.params, toks[:, None], self.cfg, self.k_pages, self.v_pages, tables, lens,
            kv_scale=self.ecfg.kv_scale)
        logits = logits[:, 0]
        return logits, greedy(logits)

    def _static_inputs(self):
        return self._toks, self._tables, self._lens

    # ------------------------------------------------------------------
    # public API (add_request, run: RequestQueue)
    # ------------------------------------------------------------------

    def step(self) -> List[Request]:
        """Admit waiting requests into free slots while pages last, then one
        decode step (or burst). Returns the requests finished in this step."""
        finished: List[Request] = []
        page = self.ecfg.page_size
        dev = self.device

        for slot in range(self.ecfg.max_slots):
            if not self.waiting or self.slot_req[slot] is not None:
                continue
            req = self.waiting[0]
            n = len(req.prompt)
            total = n + req.params.max_new_tokens
            if (total > self.ecfg.max_pages_per_seq * page
                    or n > self.ecfg.prefill_buckets[-1]):
                # Rejected before anything is allocated.
                self.waiting.pop(0)
                req.done = True
                req.error = (
                    f"rejected: prompt={n} + max_new={req.params.max_new_tokens} exceeds "
                    f"the block table ({self.ecfg.max_pages_per_seq} pages of {page}) or "
                    f"the largest prefill bucket {self.ecfg.prefill_buckets[-1]}")
                finished.append(req)
                continue
            table = SequenceTable(self.allocator)
            if not table.ensure_capacity(total):
                break  # pool exhausted: wait for running requests to finish
            self.waiting.pop(0)
            padded = np.zeros((self._bucket_for(n),), np.int32)
            padded[:n] = req.prompt
            last_logits, k_new, v_new = self._prefill(torch.as_tensor(padded, device=dev), n)
            self._insert(k_new, v_new, table.blocks[:-(-n // page)])
            tok = int(self._sample_one(last_logits, req.params))
            req.first_token_time = time.perf_counter()
            req.output.append(tok)
            req.slot = slot
            self.slot_req[slot] = req
            self.slot_tables[slot] = table
            self.slot_lens[slot] = n
            self.slot_last_tok[slot] = tok
            if self._is_stop(req, tok):
                finished.append(self._retire(slot))

        if any(r is not None for r in self.slot_req):
            width = self.ecfg.max_pages_per_seq
            tables = np.full((self.ecfg.max_slots, width), self.scratch_page, np.int32)
            for s, t in enumerate(self.slot_tables):
                if t is not None:
                    tables[s] = t.table(width)
            tables = torch.as_tensor(tables, device=dev)
            toks = torch.as_tensor(self.slot_last_tok, device=dev)
            lens = torch.as_tensor(self.slot_lens, device=dev)
            burst = self._burst_size()
            block, logits = self._run_decode_burst(toks, tables, lens, burst)
            if burst > 1:
                for i in range(burst):
                    for slot, req in enumerate(self.slot_req):
                        if req is not None:
                            # Burst rows after a slot's stop are discarded; its
                            # page writes stay inside the capacity reserved at
                            # admission.
                            self._accept(slot, req, int(block[i, slot]), finished)
                return finished
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                tok = (int(block[0, slot]) if req.params.temperature == 0.0
                       else int(self._sample_one(logits[slot], req.params)))
                self._accept(slot, req, tok, finished)
        return finished

    def _burst_size(self) -> int:
        """Largest safe burst: greedy-only active slots, capped by every
        active slot's remaining token budget (pages are reserved to max_new)
        and the config cap, bucketed; at most 8 while requests wait, so freed
        slots are refilled promptly."""
        active = [r for r in self.slot_req if r is not None]
        if not active or any(r.params.temperature != 0.0 for r in active):
            return 1
        n = min(min(r.params.max_new_tokens - len(r.output) for r in active),
                self.ecfg.decode_burst)
        if self.waiting:
            n = min(n, 8)
        for b in self._BURST_BUCKETS:
            if b <= n:
                return b
        return 1

    def _release(self, slot: int) -> None:
        self.slot_tables[slot].free()
        self.slot_tables[slot] = None

    @property
    def pages_in_use(self) -> int:
        # The allocator manages num_pages - 1 (one reserved scratch page).
        return (self.ecfg.num_pages - 1) - self.allocator.num_free
