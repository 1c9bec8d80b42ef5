"""Continuous-batching FP8 inference engine (counterpart of
``llm_fp8_tpu/serving/engine.py``).

A fixed pool of decode slots; requests prefill into free slots (prompts
padded to a bucket length) and leave on EOS or length while the other slots
keep decoding. fp8/int8 KV runs the arena path: a ``[L, B, Hk, S, Dh]`` arena
decoded by K2 (``forward_decode_arena``); bf16 KV runs the generic
:class:`KVCache` path. The arena and cache are updated in place.

``forward_fn`` serves any family with the Llama family's cache signature
(``fn(params, tokens, cfg, cache=, start_pos=, kv_lens=) -> (logits,
cache)``): the GPT-2, NeoX, Gemma-2, MoE and MLA families
(``models/registry.py``), as the JAX engine's ``forward_fn``. Those run the
generic :class:`KVCache` path (MLA's latent cache: ``init_kv_cache`` takes the
config's ``kv_cache_dims``)
(fp8 KV is quantized on store at the cache's unit scales; int8 KV is
refused). GPT-2 and NeoX compute in float32, and their tied or unquantized
head gets one float32 copy at construction (``models/zoo.py::
with_f32_head``); Gemma-2, MoE and MLA compute in bf16 and get none.

On the card a decode step is captured once as a CUDA graph over static
buffers (tokens, lengths, logits, a ``[32, slots]`` burst output; see
``cuda_graph.py``), and a burst of ``n`` greedy steps is ``n`` replays and
one read-back: the counterpart of the JAX engine's one-dispatch ``lax.scan``
burst. A sampled step replays the same graph and samples from its logits.
On the CPU a burst is a Python loop of the same step.

``mesh`` (a ``DeviceMesh`` of ``parallel/mesh.py``; the Llama family):
the JAX engine's layout on ``torch.distributed``. The weights are split
over ``tp`` (``parallel/tensor.py``: each rank's shard of the whole tree,
which a tree of ``shard_params`` is gathered into first) and whole over
``fsdp``; the slots are cut over the data axes ``(dp, fsdp)`` (JAX's
``P(("dp", "fsdp"))``; every data group holds every slot where they do not
divide ``max_slots``), so a rank's arena is ``[L, B/data, Hk/tp, S, Dh]``.
The scheduler is host logic every rank runs alike: a prefill runs on the
data group that owns the slot and its logits are broadcast to the others;
a step's logits are all-gathered over the data group before anything reads
them; a sampled token is drawn on the tp group's first rank and broadcast
over the group. int8 KV: the owner's calibrated scales and each prefill's
saturation statistics are broadcast over the data group and gathered over
``tp``, so every rank decides on every head and rescales its arena in the
same step. Ranks along ``pp``, ``cp`` and ``ep`` compute what their peers
compute, as GSPMD replicates a forward over axes it does not use. On the
card the decode step stays one CUDA graph with the NCCL collectives inside
(each group runs one collective eagerly first, so its communicator exists
before the capture).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.llama import (KVCache, forward, forward_decode_arena, init_kv_cache,
                            quantize_kv, storage_max)
from ..models.zoo import with_f32_head
from ..ops.sampling import greedy, sample
from ..utils.backend import resolve_device, resolve_kv_dtype
from .cuda_graph import StepGraph

__all__ = ["EngineConfig", "SamplingParams", "Request", "RequestQueue", "Engine"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0
    top_p: float = 0.0
    max_new_tokens: int = 128
    stop_token_ids: tuple = ()


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # [len] int32
    params: SamplingParams
    output: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    #: Set when the engine rejects or alters a request (e.g. it cannot fit).
    error: Optional[str] = None
    enqueue_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.enqueue_time


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 2048
    #: "auto" (e4m3 on an fp8-capable card, bf16 on the CPU), "fp8", "int8",
    #: "bf16" or a torch dtype. int8 calibrates per-head scales at the first
    #: prefill.
    kv_dtype: Any = "auto"
    kv_scale: float = 1.0
    prefill_buckets: tuple = (128, 256, 512, 1024, 2048)
    #: Max greedy decode steps per burst (1 = per-step decode).
    decode_burst: int = 32
    #: int8-KV drift guard: warn when the EWMA of the fraction of prefill K/V
    #: values clipping past the calibrated range crosses this threshold;
    #: kv_recalibrate also widens the scales and requantizes the arena.
    kv_sat_threshold: float = 1e-3
    kv_recalibrate: bool = False


class RequestQueue:
    """Request intake, prefill buckets, stop rules, slot retirement and the
    decode step's CUDA graph, shared by the slot-arena and the paged engine.
    The engine provides ``waiting``, ``_next_id``, ``slot_req``,
    ``slot_lens``, ``slot_last_tok``, ``ecfg.prefill_buckets``, ``eos``,
    ``_generator``, ``step``, ``_decode_step(toks, ..., lens)`` and
    ``_static_inputs()`` (the static buffers in ``_decode_step``'s argument
    order), and may override the hooks ``_slot_full`` and ``_release``."""

    _BURST_BUCKETS = (32, 16, 8, 4, 2)

    def add_request(self, prompt: np.ndarray,
                    params: SamplingParams = SamplingParams()) -> Request:
        req = Request(request_id=self._next_id, prompt=np.asarray(prompt, np.int32),
                      params=params, enqueue_time=time.perf_counter())
        self._next_id += 1
        self.waiting.append(req)
        return req

    def _bucket_for(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket")

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slot_req)

    def run(self) -> List[Request]:
        """Drain: step until every queued request completes."""
        done: List[Request] = []
        while self.has_work():
            done.extend(self.step())
        return done

    def _sample_one(self, logits: torch.Tensor, p: SamplingParams):
        if p.temperature == 0.0:
            return greedy(logits[None, :])[0]
        return self._agreed(sample(logits[None, :], self._generator,
                                   temperature=p.temperature, top_k=p.top_k,
                                   top_p=p.top_p)[0])

    def _agreed(self, tok: torch.Tensor) -> torch.Tensor:
        """Hook: the sampled token every rank goes on with."""
        return tok

    def _is_stop(self, req: Request, tok: int) -> bool:
        if len(req.output) >= req.params.max_new_tokens:
            return True
        if self.eos is not None and tok == self.eos:
            return True
        return tok in req.params.stop_token_ids

    def _slot_full(self, slot: int) -> bool:
        """Hook: whether ``slot`` has no room for another token."""
        return False

    # ------------------------------------------------------------------
    # the decode step: a CUDA graph on the card, a loop on the CPU
    # ------------------------------------------------------------------

    def _init_step_graph(self, slots: int, vocab: int, device) -> None:
        """The decode step's static buffers (the captured graph reads and
        writes only these, the weights and the caches) and its graph. An
        engine with more inputs adds their buffers to ``_static_inputs``."""
        self._toks = torch.zeros((slots,), dtype=torch.int32, device=device)
        self._lens = torch.zeros((slots,), dtype=torch.int32, device=device)
        self._logits = torch.zeros((slots, vocab), dtype=torch.float32, device=device)
        self._burst_out = torch.zeros((max(self._BURST_BUCKETS), slots), dtype=torch.int32,
                                      device=device)
        self._row = torch.zeros((1,), dtype=torch.int64, device=device)
        self.step_graph = StepGraph(
            self._graph_step, (self._toks, self._lens, self._logits, self._burst_out, self._row))

    def _graph_step(self):
        """The step the CUDA graph captures, over the static buffers: the
        greedy token goes back into ``_toks`` and into row ``_row`` of
        ``_burst_out``, the logits into ``_logits``; ``_lens`` advances."""
        logits, toks = self._decode_step(*self._static_inputs())
        self._logits.copy_(logits)
        self._toks.copy_(toks)
        self._burst_out.index_copy_(0, self._row, toks[None])
        self._row.add_(1)
        self._lens.add_(1)

    def _replay_steps(self, *args):
        """``args = (*inputs, steps)``: ``steps`` replays of the captured step
        from ``inputs`` (captured at the first call); one read-back."""
        *inputs, steps = args
        for buf, x in zip(self._static_inputs(), inputs):
            buf.copy_(x)
        self._row.zero_()
        if not self.step_graph.captured:
            self.step_graph.capture()
        for _ in range(steps):
            self.step_graph.replay()
        return self._burst_out[:steps].cpu().numpy(), self._logits

    def _decode_loop(self, *args):
        """``args = (toks, ..., lens, steps)``: ``steps`` eager decode steps;
        tokens stay on the device and are read back once."""
        *inputs, steps = args
        out = []
        for _ in range(steps):
            logits, toks = self._decode_step(*inputs)
            inputs[0], inputs[-1] = toks, inputs[-1] + 1
            out.append(toks)
        return torch.stack(out).cpu().numpy(), logits

    def _run_decode_burst(self, *args):
        """``args = (toks, ..., lens, steps)``: ``steps`` greedy decode steps,
        ``(tokens [steps, slots] on the host, the last step's logits [slots,
        V])``. Replays of the captured step on the card, the loop on the
        CPU."""
        if self.device.type == "cuda":
            return self._replay_steps(*args)
        return self._decode_loop(*args)

    def _release(self, slot: int) -> None:
        """Hook: give back what ``slot`` holds beyond its request."""

    def _accept(self, slot: int, req: Request, tok: int, finished: List[Request]):
        req.output.append(tok)
        self.slot_lens[slot] += 1
        self.slot_last_tok[slot] = tok
        if self._is_stop(req, tok) or self._slot_full(slot):
            finished.append(self._retire(slot))

    def _retire(self, slot: int) -> Request:
        req = self.slot_req[slot]
        req.done = True
        req.finish_time = time.perf_counter()
        req.slot = -1
        self.slot_req[slot] = None
        self._release(slot)
        self.slot_lens[slot] = 0
        self.slot_last_tok[slot] = 0
        return req


class Engine(RequestQueue):
    """Single-model engine; params may hold QTensor fp8/int8 weights.

    Runs on ``cuda`` unless ``device`` is given (``device="cpu"`` runs the
    plain versions of the kernels). ``forward_fn``: the family's forward
    (default: the Llama family's ``forward``). ``mesh``: serve over a
    ``DeviceMesh`` (module docstring); another family's ``forward_fn``
    raises ``NotImplementedError`` there above one rank."""

    #: Subclass hook: engines whose steps feed several tokens opt out of the
    #: single-token arena path (as the JAX package's speculative engine does).
    _use_arena = True

    def __init__(self, params: Dict[str, Any], model_cfg: ModelConfig,
                 engine_cfg: EngineConfig = EngineConfig(), *,
                 eos_token_id: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None, forward_fn=None, mesh=None):
        self.device = resolve_device(device)
        self._forward = forward_fn if forward_fn is not None else forward
        #: The whole model's config (``cfg`` is this rank's under a mesh).
        self.model_cfg = model_cfg
        self.tp = None
        self._data, self._data_index = None, 0
        self._nslots = engine_cfg.max_slots
        if mesh is not None:
            params, model_cfg = self._mesh_shard(params, model_cfg, mesh, engine_cfg.max_slots)
        self.params = params if self._forward is forward else with_f32_head(params)
        self.cfg = model_cfg
        buckets = tuple(b for b in engine_cfg.prefill_buckets
                        if b <= engine_cfg.max_seq_len) or (engine_cfg.max_seq_len,)
        engine_cfg = dataclasses.replace(
            engine_cfg, kv_dtype=resolve_kv_dtype(engine_cfg.kv_dtype, self.device),
            prefill_buckets=buckets)
        self.ecfg = engine_cfg
        self.eos = eos_token_id
        B, S = engine_cfg.max_slots, engine_cfg.max_seq_len
        kv_dtype = engine_cfg.kv_dtype
        self._fp8_arena = (kv_dtype in (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)
                           and self._forward is forward and type(self)._use_arena)
        self._int8_kv = kv_dtype == torch.int8
        if self._int8_kv and not self._fp8_arena:
            # Only the arena path carries calibrated per-head scales; int8 at
            # the unit scale would truncate K/V to ±1 and wreck the logits.
            raise ValueError(
                "int8 KV requires the fused-arena engine path (Llama-family "
                "forward); use kv_dtype='bf16' or 'fp8' for this model")
        self._calibrated = not self._int8_kv
        Hk = model_cfg.num_kv_heads
        #: This rank's kv heads among the whole model's (the drift statistics
        #: cover every head).
        h0 = self.tp.rank * Hk if self.tp is not None and self.tp.layout.heads else 0
        self._heads = (h0, h0 + Hk)
        dev = self.device
        self._kscales = torch.full((Hk,), engine_cfg.kv_scale, dtype=torch.float32, device=dev)
        self._vscales = torch.full((Hk,), engine_cfg.kv_scale, dtype=torch.float32, device=dev)
        self._sat_ewma_k = np.zeros((self.model_cfg.num_kv_heads,), np.float64)
        self._sat_ewma_v = np.zeros((self.model_cfg.num_kv_heads,), np.float64)
        self.kv_sat_warning = False
        self.kv_recalibrations = 0
        if self._fp8_arena:
            L, Dh = model_cfg.num_layers, model_cfg.head_dim
            self.ka = torch.zeros((L, self._nslots, Hk, S, Dh), dtype=kv_dtype, device=dev)
            self.va = torch.zeros((L, self._nslots, Hk, S, Dh), dtype=kv_dtype, device=dev)
            self.cache = None
        else:
            self.cache: KVCache = init_kv_cache(model_cfg, self._nslots, S, dtype=kv_dtype,
                                                device=dev)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_lens = np.zeros((B,), np.int32)
        self.slot_last_tok = np.zeros((B,), np.int32)
        self.waiting: List[Request] = []
        self._next_id = 0
        self._generator = generator or torch.Generator(device=dev).manual_seed(0)
        self._init_step_graph(B, self.model_cfg.vocab_size, dev)

    def _mesh_shard(self, params, model_cfg: ModelConfig, mesh, slots: int):
        """This rank's shard and config under ``mesh``; sets the tp group and
        the data group over which the slots are cut (module docstring)."""
        from ..parallel.collectives import all_reduce_sum
        from ..parallel.mesh import (AXIS_DP, AXIS_FSDP, AXIS_TP, axis_sizes, data_group,
                                     data_index, tp_group)
        from ..parallel.sharding import gather_tree
        from ..parallel.tensor import tp_shard

        if self._forward is not forward:
            if mesh.mesh.numel() > 1:
                raise NotImplementedError(
                    "Engine(mesh=) over more than one rank serves the Llama family's forward "
                    "only; other families under a mesh are not ported yet (ROADMAP.md, "
                    "Queue 1: \"The other families over a mesh\")")
            return params, model_cfg  # a world of one computes the mesh-less function
        sizes = axis_sizes(mesh)
        params, model_cfg, self.tp = tp_shard(gather_tree(params), model_cfg, sizes[AXIS_TP],
                                              mesh.get_local_rank(AXIS_TP), tp_group(mesh))
        n_data = sizes[AXIS_DP] * sizes[AXIS_FSDP]
        if slots % n_data == 0:  # else every data group holds every slot (JAX's adapt_spec)
            self._data, self._data_index = data_group(mesh), data_index(mesh)
            self._nslots = slots // n_data
        for group in (self.tp.group, self._data):
            if group is not None:
                all_reduce_sum(torch.zeros((1,), device=self.device), group)
        return params, model_cfg

    def _owner(self, slot: int):
        """``(data index of the group holding slot, its row there)``."""
        if self._data is None:
            return self._data_index, slot
        return divmod(slot, self._nslots)

    def _shared_logits(self, last, owner: int):
        """The owner's prefill logits on every rank of the data group."""
        if self._data is None:
            return last
        from ..parallel.collectives import broadcast

        if last is None:
            last = torch.zeros((self.model_cfg.vocab_size,), dtype=torch.float32,
                               device=self.device)
        return broadcast(last, self._data, owner)

    def _shared_stats(self, stats, owner: int):
        """A prefill's per-head saturation statistics ``(k_sat, k_amax,
        v_sat, v_amax)`` of every kv head, on every rank: the owner's,
        broadcast over the data group and gathered over ``tp``."""
        from ..parallel.collectives import all_gather, broadcast

        if self._data is not None:
            t = (torch.stack(stats) if stats is not None else
                 torch.zeros((4, self.cfg.num_kv_heads), dtype=torch.float32,
                             device=self.device))
            stats = tuple(broadcast(t, self._data, owner).unbind(0))
        if self.tp is not None and self.tp.layout.heads:
            stats = tuple(all_gather(torch.stack(stats), 1, self.tp.group).unbind(0))
        return stats

    def _agreed(self, tok: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return tok
        from ..parallel.collectives import broadcast

        return broadcast(tok.reshape(1), self.tp.group)[0]

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------

    def _prefill_kv(self, tokens, true_len):
        """Run the prompt without a cache; return last-position logits and
        the raw per-layer K/V ``[L, 1, bucket, Hk, Dh]``."""
        logits, kv = forward(self.params, tokens[None, :], self.cfg,
                             kv_lens=true_len.reshape(1), return_kv=True, tp=self.tp)
        return logits[0, int(true_len) - 1], kv

    @staticmethod
    def _store_arena(arena, new, scales, slot):
        """Quantize ``[L, 1, bucket, Hk, Dh]`` K or V by per-head ``scales``
        into ``arena[:, slot, :, :bucket]`` in place."""
        arena[:, slot, :, :new.shape[2]] = quantize_kv(
            new[:, 0].permute(0, 2, 1, 3), scales.reshape(1, -1, 1, 1), arena.dtype)

    @staticmethod
    def _sat_stats(new, scales, true_len, fmax):
        """Per-head saturation fraction and amax of a raw prefill K or V."""
        a = new[:, 0].float().abs()  # [L, bucket, Hk, Dh]
        valid = (torch.arange(a.shape[1], device=a.device) < true_len)[None, :, None, None]
        rng = scales.reshape(1, 1, -1, 1) * fmax
        sat = torch.where(valid, (a > rng).float(), torch.zeros_like(a)).sum(dim=(0, 1, 3))
        denom = max(int(true_len) * a.shape[0] * a.shape[-1], 1)
        amax = torch.where(valid, a, torch.zeros_like(a)).amax(dim=(0, 1, 3))
        return sat / denom, amax

    def _prefill_arena(self, tokens, true_len, slot):
        last, (k, v) = self._prefill_kv(tokens, true_len)
        fmax = storage_max(self.ka.dtype)
        stats = (self._sat_stats(k, self._kscales, true_len, fmax)
                 + self._sat_stats(v, self._vscales, true_len, fmax))
        self._store_arena(self.ka, k, self._kscales, slot)
        self._store_arena(self.va, v, self._vscales, slot)
        return last, stats

    def _calibrate_int8_kv(self, tokens, true_len, slot):
        """First-prefill int8 calibration: per-head scales from the prompt's
        K/V amaxes with 5% headroom, then quantize and store."""
        last, (k, v) = self._prefill_kv(tokens, true_len)
        n = int(true_len)
        amax_k = k[:, 0, :n].float().abs().amax(dim=(0, 1, 3))
        amax_v = v[:, 0, :n].float().abs().amax(dim=(0, 1, 3))
        # In place: the captured decode step reads these tensors.
        self._kscales.copy_(torch.clamp(amax_k, min=1e-6) * 1.05 / 127.0)
        self._vscales.copy_(torch.clamp(amax_v, min=1e-6) * 1.05 / 127.0)
        self._calibrated = True
        self._store_arena(self.ka, k, self._kscales, slot)
        self._store_arena(self.va, v, self._vscales, slot)
        return last

    def _run_prefill(self, padded, true_len, slot):
        """Prefill ``slot`` (on the data group holding it); its last logits
        on every rank."""
        owner, row = self._owner(slot)
        mine = owner == self._data_index
        if self._fp8_arena:
            if not self._calibrated:
                last = self._calibrate_int8_kv(padded, true_len, row) if mine else None
                if self._data is not None:  # one set of scales for every slot
                    from ..parallel.collectives import broadcast

                    self._kscales.copy_(broadcast(self._kscales, self._data, owner))
                    self._vscales.copy_(broadcast(self._vscales, self._data, owner))
                    self._calibrated = True
                return self._shared_logits(last, owner)
            last, stats = self._prefill_arena(padded, true_len, row) if mine else (None, None)
            if self._int8_kv:
                self._track_kv_drift(self._shared_stats(stats, owner))
            return self._shared_logits(last, owner)
        last = None
        if mine:
            bucket = padded.shape[0]
            one = init_kv_cache(self.cfg, 1, bucket, dtype=self.ecfg.kv_dtype,
                                device=self.device)
            one = dataclasses.replace(one, k_scale=self.cache.k_scale,
                                      v_scale=self.cache.v_scale)
            logits, one = self._forward(self.params, padded[None, :], self.cfg, cache=one,
                                        start_pos=0, kv_lens=true_len.reshape(1),
                                        **self._tp_kw())
            self.cache.k[:, row, :bucket] = one.k[:, 0]
            self.cache.v[:, row, :bucket] = one.v[:, 0]
            self.cache.lens[row] = true_len
            last = logits[0, int(true_len) - 1]
        return self._shared_logits(last, owner)

    def _tp_kw(self):
        return {} if self.tp is None else {"tp": self.tp}

    def _track_kv_drift(self, stats):
        """Update the saturation EWMA, warn past the threshold, optionally
        widen the scales."""
        k_sat, k_amax, v_sat, v_amax = (s.double().cpu().numpy() for s in stats)
        a = 0.2
        self._sat_ewma_k = (1 - a) * self._sat_ewma_k + a * k_sat
        self._sat_ewma_v = (1 - a) * self._sat_ewma_v + a * v_sat
        worst = max(self._sat_ewma_k.max(), self._sat_ewma_v.max())
        if worst > self.ecfg.kv_sat_threshold and not self.kv_sat_warning:
            self.kv_sat_warning = True
            warnings.warn(
                f"int8-KV saturation EWMA {worst:.2%} exceeds "
                f"kv_sat_threshold={self.ecfg.kv_sat_threshold:.2%}: activations "
                "have drifted past the first-prefill calibration range"
                + ("" if self.ecfg.kv_recalibrate
                   else "; set EngineConfig.kv_recalibrate=True to expand scales online"),
                stacklevel=3)
        if self.ecfg.kv_recalibrate and (k_sat.max() > self.ecfg.kv_sat_threshold
                                         or v_sat.max() > self.ecfg.kv_sat_threshold):
            dev = self.device
            h0, h1 = self._heads
            new_ks = torch.maximum(self._kscales, torch.as_tensor(
                k_amax[h0:h1] * 1.05 / 127.0, dtype=torch.float32, device=dev))
            new_vs = torch.maximum(self._vscales, torch.as_tensor(
                v_amax[h0:h1] * 1.05 / 127.0, dtype=torch.float32, device=dev))
            self._rescale_arena(new_ks, new_vs)
            self.kv_recalibrations += 1

    def _rescale_arena(self, new_ks, new_vs):
        """Requantize the live int8 arena in place from the old scales to
        widened ones: ``q_new = round(q_old * old / new)``."""
        for arena, old, new in ((self.ka, self._kscales, new_ks),
                                (self.va, self._vscales, new_vs)):
            ratio = (old / new).reshape(1, 1, -1, 1, 1)
            arena.copy_(torch.clamp(torch.round(arena.float() * ratio), -127, 127).to(arena.dtype))
        self._kscales.copy_(new_ks)
        self._vscales.copy_(new_vs)

    def kv_drift_stats(self) -> Dict[str, Any]:
        return {
            "sat_ewma_k_max": float(self._sat_ewma_k.max()),
            "sat_ewma_v_max": float(self._sat_ewma_v.max()),
            "sat_threshold": self.ecfg.kv_sat_threshold,
            "warning": self.kv_sat_warning,
            "recalibrations": self.kv_recalibrations,
        }

    def _decode_step(self, toks, lens):
        """One decode step over every slot: ``(logits [B, V], greedy [B])``.
        The arena or cache is written in place (the forwards return the same
        tensors), so a captured step writes the engine's own storage. Under a
        mesh the rank steps its data group's slots and the logits of every
        slot are gathered."""
        if self._data is not None:
            s0 = self._data_index * self._nslots
            toks, lens = toks[s0:s0 + self._nslots], lens[s0:s0 + self._nslots]
        if self._fp8_arena:
            logits, _, _ = forward_decode_arena(
                self.params, toks[:, None], self.cfg, self.ka, self.va, lens,
                kv_scale=(self._kscales, self._vscales), window=self.cfg.sliding_window,
                tp=self.tp)
        else:
            logits, cache = self._forward(
                self.params, toks[:, None], self.cfg, cache=self.cache, start_pos=lens,
                kv_lens=lens + 1, **self._tp_kw())
            self.cache.lens.copy_(cache.lens)
        logits = logits[:, 0]
        if self._data is not None:
            from ..parallel.collectives import all_gather

            logits = all_gather(logits, 0, self._data)
        return logits, greedy(logits)

    def _static_inputs(self):
        return self._toks, self._lens

    def _burst_size(self) -> int:
        """Largest safe burst: greedy-only active slots, capped by each slot's
        token budget and arena headroom; at most 8 while requests wait."""
        active = [(s, r) for s, r in enumerate(self.slot_req) if r is not None]
        if not active or any(r.params.temperature != 0.0 for _, r in active):
            return 1
        n = min(min(r.params.max_new_tokens - len(r.output) for _, r in active),
                min(self.ecfg.max_seq_len - 1 - int(self.slot_lens[s]) for s, _ in active),
                self.ecfg.decode_burst)
        if self.waiting:
            n = min(n, 8)
        for b in self._BURST_BUCKETS:
            if b <= n:
                return b
        return 1

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _slot_full(self, slot: int) -> bool:
        return self.slot_lens[slot] + 1 >= self.ecfg.max_seq_len

    def step(self) -> List[Request]:
        """Admit waiting requests into free slots, then one decode step (or
        burst). Returns the requests finished during this step."""
        finished: List[Request] = []
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
            self.waiting.pop(0)
            bucket = self._bucket_for(len(req.prompt))
            padded = np.zeros((bucket,), np.int32)
            padded[: len(req.prompt)] = req.prompt
            last_logits = self._run_prefill(
                torch.as_tensor(padded, device=dev),
                torch.tensor(len(req.prompt), dtype=torch.int32, device=dev), slot)
            tok = int(self._sample_one(last_logits, req.params))
            req.first_token_time = time.perf_counter()
            req.output.append(tok)
            req.slot = slot
            self.slot_req[slot] = req
            self.slot_lens[slot] = len(req.prompt)
            self.slot_last_tok[slot] = tok
            if self._is_stop(req, tok):
                finished.append(self._retire(slot))

        if any(r is not None for r in self.slot_req):
            lens = torch.as_tensor(self.slot_lens, device=dev)
            toks = torch.as_tensor(self.slot_last_tok, device=dev)
            burst = self._burst_size()
            block, logits = self._run_decode_burst(toks, lens, burst)
            if burst > 1:
                for i in range(burst):
                    for slot, req in enumerate(self.slot_req):
                        if req is not None:
                            self._accept(slot, req, int(block[i, slot]), finished)
                return finished
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                tok = (int(block[0, slot]) if req.params.temperature == 0.0
                       else int(self._sample_one(logits[slot], req.params)))
                self._accept(slot, req, tok, finished)
        return finished
