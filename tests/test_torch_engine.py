"""The port's serving engine against the JAX engine on a debug config.

Both engines serve the same three requests (mixed prompt lengths, two slots,
so the third waits for a slot) with the same weights, greedy, one decode step
per dispatch so that every step's logits can be read. At every step the
logits agree within the bf16 tolerance of ``test_torch_llama.py`` (atol
2e-2). Random-weight logits are nearly flat, so the tokens must agree only
where the JAX top-1/top-2 gap exceeds 4x that tolerance; after a permitted
divergence at a near-tie the two runs decode different text and that
request's comparison stops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu.quant import LAYERWISE as J_LAYERWISE
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu.serving import engine as jengine
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import config as tconfig
from llm_fp8_tpu_torch.serving import engine as tengine

TOL = 2e-2
PROMPT_LENS = (5, 12, 20)
MAX_NEW = 6


def numpy_tree(tree):
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


class JaxRecorder(jengine.Engine):
    """JAX engine that records each request's logits rows."""

    def _run_prefill(self, padded, n, slot, bucket):
        last = super()._run_prefill(padded, n, slot, bucket)
        self.rows.append([np.asarray(last, np.float32)])
        return last

    def _run_decode(self, toks, lens):
        logits, g = super()._run_decode(toks, lens)
        host = np.asarray(logits, np.float32)
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                self.rows[req.request_id].append(host[slot])
        return logits, g


class TorchRecorder(tengine.Engine):
    """Port engine that records each request's logits rows."""

    def _run_prefill(self, padded, true_len, slot):
        last = super()._run_prefill(padded, true_len, slot)
        self.rows.append([last.float().numpy()])
        return last

    def _decode_step(self, toks, lens):
        logits, g = super()._decode_step(toks, lens)
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                self.rows[req.request_id].append(logits[slot].float().numpy())
        return logits, g


@pytest.fixture(scope="module")
def models():
    jc = jconfig.get_config("debug-tiny")
    tc = tconfig.get_config("debug-tiny")
    jp = jllama.quantize_params(
        jllama.init_params(jc, jax.random.PRNGKey(4), dtype=jnp.bfloat16), J_LAYERWISE)
    return jc, tc, jp, params_from_numpy(numpy_tree(jp))


def _serve(cls, params, cfg, mod, kv, ecfg_kw, **kw):
    """Serve the three requests through engine class ``cls`` of module ``mod``."""
    ecfg = mod.EngineConfig(max_slots=2, max_seq_len=128, prefill_buckets=(32,),
                            kv_dtype=kv, decode_burst=1, **ecfg_kw)
    eng = cls(params, cfg, ecfg, **kw)
    eng.rows = []
    rng = np.random.default_rng(9)
    reqs = [eng.add_request(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                            mod.SamplingParams(max_new_tokens=MAX_NEW))
            for n in PROMPT_LENS]
    eng.run()
    return eng, reqs


#: int8-recalibrate: the drift guard widens the calibrated scales when a later
#: prefill clips past them, and requantizes the live arena.
ENGINE_CASES = {"fp8": ("fp8", {}), "int8": ("int8", {}), "bf16": ("bf16", {}),
                "int8-recalibrate": ("int8", dict(kv_recalibrate=True, kv_sat_threshold=1e-4))}


@pytest.mark.parametrize("kv", list(ENGINE_CASES))
def test_engine_matches_jax_engine(models, kv):
    jc, tc, jp, tp = models
    kv, ecfg_kw = ENGINE_CASES[kv]
    jeng, jreqs = _serve(JaxRecorder, jp, jc, jengine, kv, ecfg_kw)
    teng, treqs = _serve(TorchRecorder, tp, tc, tengine, kv, ecfg_kw, device="cpu")
    assert teng._fp8_arena == jeng._fp8_arena == (kv != "bf16")
    guarded = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.output) == MAX_NEW
        assert len(jeng.rows[jr.request_id]) == len(teng.rows[tr.request_id]) == MAX_NEW
        for step, (jrow, trow) in enumerate(zip(jeng.rows[jr.request_id],
                                                teng.rows[tr.request_id])):
            np.testing.assert_allclose(trow, jrow, rtol=0, atol=TOL,
                                       err_msg=f"request {jr.request_id} step {step}")
            top2 = np.sort(jrow)[-2:]
            if top2[1] - top2[0] > 4 * TOL:
                guarded += 1
                assert tr.output[step] == jr.output[step], (jr.request_id, step)
            elif tr.output[step] != jr.output[step]:
                break  # a near-tie went the other way: the texts part here
    assert guarded > 0
    if kv == "int8":
        np.testing.assert_allclose(teng._kscales.numpy(), np.asarray(jeng._kscales),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(teng._vscales.numpy(), np.asarray(jeng._vscales),
                                   rtol=0, atol=1e-6)
        assert teng.kv_drift_stats() == pytest.approx(jeng.kv_drift_stats())
        assert teng.kv_recalibrations == jeng.kv_recalibrations
        assert (teng.kv_recalibrations > 0) == bool(ecfg_kw)


def test_int8_kv_refused_off_the_arena_path(models):
    jc, tc, jp, tp = models

    class NoArena(tengine.Engine):
        _use_arena = False

    class JaxNoArena(jengine.Engine):
        _use_arena = False

    cfg = dict(max_slots=2, max_seq_len=64, kv_dtype="int8")
    with pytest.raises(ValueError, match="int8 KV requires the fused-arena"):
        JaxNoArena(jp, jc, jengine.EngineConfig(**cfg))
    with pytest.raises(ValueError, match="int8 KV requires the fused-arena"):
        NoArena(tp, tc, tengine.EngineConfig(**cfg), device="cpu")
    # fp8 KV off the arena path takes the generic cache instead.
    eng = NoArena(tp, tc, tengine.EngineConfig(**dict(cfg, kv_dtype="fp8")), device="cpu")
    assert eng.cache is not None and eng.cache.k.dtype == torch.float8_e4m3fn


def test_oversized_request_rejected_not_crashed(models):
    _, tc, _, tp = models
    eng = tengine.Engine(tp, tc, tengine.EngineConfig(max_slots=1, max_seq_len=32,
                                                      prefill_buckets=(16,)), device="cpu")
    big = eng.add_request(np.arange(1, 31, dtype=np.int32),
                          tengine.SamplingParams(max_new_tokens=8))
    ok = eng.add_request(np.arange(1, 9, dtype=np.int32),
                         tengine.SamplingParams(max_new_tokens=4))
    done = eng.run()
    assert big.done and big.error is not None and "rejected" in big.error and not big.output
    assert ok.done and ok.error is None and len(ok.output) == 4
    assert {r.request_id for r in done} == {big.request_id, ok.request_id}


class BodySteps(tengine.Engine):
    """Runs the step the CUDA graph captures, eagerly over its static
    buffers, where the card would replay it."""

    def _run_decode_burst(self, toks, lens, steps):
        self._toks.copy_(toks)
        self._lens.copy_(lens)
        self._row.zero_()
        for _ in range(steps):
            self._graph_step()
        return self._burst_out[:steps].numpy().copy(), self._logits


@pytest.mark.parametrize("kv,temperature", [("fp8", 0.0), ("int8", 0.0), ("bf16", 0.0),
                                            ("fp8", 0.8)])
def test_graph_step_body_matches_the_loop(models, kv, temperature):
    """The captured step's body over the static buffers commits the loop's
    tokens: greedy bursts (every arena dtype and the bf16 KVCache path) and
    sampled single steps, which sample from the static logits."""
    _, tc, _, tp = models
    ecfg = tengine.EngineConfig(max_slots=2, max_seq_len=128, prefill_buckets=(32,),
                                kv_dtype=kv, decode_burst=32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tc.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    outs = []
    for cls in (tengine.Engine, BodySteps):
        eng = cls(tp, tc, ecfg, device="cpu", generator=torch.Generator().manual_seed(2))
        reqs = [eng.add_request(p, tengine.SamplingParams(max_new_tokens=10,
                                                          temperature=temperature))
                for p in prompts]
        eng.run()
        assert all(r.done and r.error is None and len(r.output) == 10 for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_int8_calibration_and_rescale_keep_the_scale_storage(models):
    """The captured step reads the per-head scales by address: calibration
    and the drift guard's requantization update them in place."""
    _, tc, _, tp = models
    eng = tengine.Engine(tp, tc, tengine.EngineConfig(
        max_slots=2, max_seq_len=128, prefill_buckets=(32,), kv_dtype="int8",
        kv_recalibrate=True, kv_sat_threshold=1e-4), device="cpu")
    ptrs = [t.data_ptr() for t in (eng._kscales, eng._vscales, eng.ka, eng.va)]
    rng = np.random.default_rng(9)
    for n in PROMPT_LENS:
        eng.add_request(rng.integers(1, tc.vocab_size, n).astype(np.int32),
                        tengine.SamplingParams(max_new_tokens=4))
    eng.run()
    assert eng.kv_recalibrations > 0
    assert not torch.equal(eng._kscales, torch.ones_like(eng._kscales))
    assert [t.data_ptr() for t in (eng._kscales, eng._vscales, eng.ka, eng.va)] == ptrs


def test_rotary_frequencies_are_built_once_per_device(models, monkeypatch):
    from llm_fp8_tpu_torch.models import llama as tl
    from llm_fp8_tpu_torch.ops.rotary import rope_cos_sin, rope_frequencies

    _, tc, _, tp = models
    tl._inv_freq.cache_clear()
    calls = []
    monkeypatch.setattr(tl, "rope_frequencies",
                        lambda *a: (calls.append(a), rope_frequencies(*a))[1])
    cfg = tconfig.get_config("llama-3.2-1b")  # llama3 scaling: the dict is part of the key
    for start in (0, 7, 100):
        pos = torch.arange(start, start + 3, dtype=torch.int32)[None]
        got = tl._rope_tables(cfg, pos)
        want = rope_cos_sin(pos, rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                                  cfg.rope_scaling), cfg.rope_scaling)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(calls) == 1
    eng = tengine.Engine(tp, tc, tengine.EngineConfig(max_slots=2, max_seq_len=64,
                                                      prefill_buckets=(16,)), device="cpu")
    eng.add_request(np.arange(1, 9, dtype=np.int32), tengine.SamplingParams(max_new_tokens=5))
    eng.run()
    assert len(calls) == 2  # one more model shape, built once for all its steps
    tl._inv_freq.cache_clear()


def test_graph_capture_pauses_cyclic_garbage_collection(monkeypatch):
    """``StepGraph.capture`` runs the captured body with Python's cyclic
    collector paused (a collection inside a capture can free another
    engine's graph, which invalidates the capture on the card) and restores
    it after, also when the body raises. The card's stream and graph calls
    are stood in for by no-ops on this CPU build."""
    import contextlib
    import gc

    from llm_fp8_tpu_torch.serving.cuda_graph import StepGraph

    class Fake:
        def __init__(self, *a, **k):
            pass

        def __getattr__(self, name):
            return lambda *a, **k: None

    monkeypatch.setattr(torch.cuda, "Stream", Fake)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Fake())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    seen = []
    graph = StepGraph(lambda: seen.append(gc.isenabled()), state=[torch.zeros(2)])
    assert gc.isenabled()
    graph.capture()
    assert seen == [True, False] and gc.isenabled() and graph.captures == 1

    def boom():
        seen.append(gc.isenabled())
        if len(seen) > 3:
            raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        StepGraph(boom, state=[]).capture()
    assert seen[2:] == [True, False] and gc.isenabled()
