"""The port's paged serving path against the JAX package on debug-tiny.

* Block allocator and sequence tables: the same operations give the same
  block ids and reference counts as the JAX ones.
* ``forward_paged`` (LAYERWISE fp8 weights, e4m3 pool, two decode steps)
  against the JAX one: logits within the bf16 tolerance of
  ``test_torch_llama.py`` (atol 2e-2); the pools code for code in layer 0,
  where both sides append the same bf16 K/V. From layer 1 on the K/V that
  reach the append already differ by the bf16 roundings that tolerance
  covers, so there an appended code may be the neighbouring e4m3 code.
* ``PagedEngine`` against the JAX ``PagedEngine`` on bf16 and e4m3 pools:
  the same greedy tokens, token for token, for three requests on two slots
  (the third waits for a slot and reuses freed pages).
* Torch side only: burst decode equals per-step decode, pages are reused,
  a full pool queues requests, over-long prompts are rejected.
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
from llm_fp8_tpu.serving import block_table as jbt
from llm_fp8_tpu.serving import paged_engine as jpe
from llm_fp8_tpu.serving.engine import SamplingParams as JSamplingParams
from llm_fp8_tpu_torch.convert import params_from_numpy, pool_from_numpy, pool_to_numpy
from llm_fp8_tpu_torch.models import config as tconfig
from llm_fp8_tpu_torch.models import llama as tllama
from llm_fp8_tpu_torch.serving import block_table as tbt
from llm_fp8_tpu_torch.serving import paged_engine as tpe
from llm_fp8_tpu_torch.serving.engine import SamplingParams

TOL = 2e-2
PAGE = 16
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


@pytest.fixture(scope="module")
def models():
    jc = jconfig.get_config("debug-tiny")
    tc = tconfig.get_config("debug-tiny")
    jp = jllama.quantize_params(
        jllama.init_params(jc, jax.random.PRNGKey(4), dtype=jnp.bfloat16), J_LAYERWISE)
    return jc, tc, jp, params_from_numpy(numpy_tree(jp))


def test_block_allocator_matches_jax():
    ja, ta = jbt.BlockAllocator(12, PAGE), tbt.BlockAllocator(12, PAGE)
    log = []
    for a in (ja, ta):
        seen = [a.alloc(3).tolist(), a.alloc(4).tolist()]
        a.release(np.asarray([1, 5], np.int32))
        seen.append(a.alloc(3).tolist())
        seen.append(a.fork(np.asarray([0, 2], np.int32)))
        seen.append(a.fork(np.asarray([0, 11], np.int32)))  # 11 is free: refused
        a.release(np.asarray([0, 0, 0, 99], np.int32))  # extra and unknown ids ignored
        seen.append([a.refcount(b) for b in range(12)])
        seen.append(a.alloc(9))  # more than is free: nothing allocated
        seen += [a.num_free, a.alloc(0).tolist()]
        log.append(seen)
    assert log[0][-3] is None and log[1][-3] is None
    assert log[0] == log[1]
    assert log[1][0] == [0, 1, 2] and log[1][2] == [5, 1, 7]


def test_sequence_table_matches_jax():
    rows = []
    for bt in (jbt, tbt):
        a = bt.BlockAllocator(6, PAGE)
        s1, s2 = bt.SequenceTable(a), bt.SequenceTable(a)
        got = [s1.ensure_capacity(20), s2.ensure_capacity(PAGE), s1.ensure_capacity(40),
               s2.ensure_capacity(5 * PAGE)]  # the last does not fit
        got += [s1.table(5).tolist(), s2.table(5).tolist(), a.num_free]
        s1.free()
        got += [s1.blocks, a.num_free, s2.ensure_capacity(3 * PAGE), s2.table(5).tolist()]
        rows.append(got)
    assert rows[0] == rows[1]
    assert rows[1][3] is False and rows[1][4] == [0, 1, 3, 0, 0]


def test_forward_paged_matches_jax(models):
    """Two decode steps over an e4m3 pool holding three sequences (one ends
    on a page boundary before its append), same pool codes in, same tokens
    fed: logits within 2e-2, layer 0 code for code, later layers within one
    code step, and nothing but the appended rows changed."""
    jc, tc, jp, tp = models
    rng = np.random.default_rng(5)
    L, Hk, Dh = jc.num_layers, jc.num_kv_heads, jc.head_dim
    P, width = 12, 4
    pool = lambda: jnp.asarray(np.clip(rng.standard_normal(  # noqa: E731
        (P, L, Hk, Dh, PAGE)).astype(np.float32), -448, 448)).astype(jnp.float8_e4m3fn)
    kp, vp = pool(), pool()
    tables = np.asarray([[3, 7, 0, 0], [5, 6, 0, 0], [1, 2, 9, 10]], np.int32)
    lens = np.asarray([20, PAGE, 40], np.int32)
    toks = rng.integers(1, jc.vocab_size, (3, 1)).astype(np.int32)
    jstep = jax.jit(lambda p, t, k, v, tb, n: jllama.forward_paged(p, t, jc, k, v, tb, n))
    tk, tv = pool_from_numpy(kp), pool_from_numpy(vp)
    before = np.asarray(kp).view(np.uint8).copy()
    order = lambda c: np.where(c & 0x80, -(c & 0x7F).astype(int), c & 0x7F)  # noqa: E731
    for _ in range(2):
        jl, kp, vp = jstep(jp, jnp.asarray(toks), kp, vp, jnp.asarray(tables), jnp.asarray(lens))
        tl, tk, tv = tllama.forward_paged(tp, torch.from_numpy(toks), tc, tk, tv,
                                          torch.from_numpy(tables), torch.from_numpy(lens))
        assert tl.shape == (3, 1, jc.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
        for got, want in ((pool_to_numpy(tk), np.asarray(kp).view(np.uint8)),
                          (pool_to_numpy(tv), np.asarray(vp).view(np.uint8))):
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            assert np.abs(order(got) - order(want)).max() <= 1
        toks = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
        lens = lens + 1
    # Only the two appended rows of each sequence changed: pages x layers x
    # heads x D x (positions lens-2, lens-1) of the lane-major pool.
    after = pool_to_numpy(tk)
    changed = np.argwhere((after != before).any(axis=3))  # [page, layer, head, offset]
    rows = {(int(pg), int(off)) for pg, _, _, off in changed}
    assert rows == {(int(tables[b, p // PAGE]), int(p % PAGE))
                    for b in range(3) for p in (lens[b] - 2, lens[b] - 1)}


def _engine_cfg(mod, kv_dtype, **kw):
    base = dict(max_slots=2, num_pages=12, page_size=PAGE, max_pages_per_seq=4,
                kv_dtype=kv_dtype, prefill_buckets=(PAGE, 2 * PAGE), decode_burst=1)
    base.update(kw)
    return mod.PagedEngineConfig(**base)


def _prompts(cfg, lens=PROMPT_LENS, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("kv", ["bf16", "e4m3"])
def test_paged_engine_matches_jax_engine_token_for_token(models, kv):
    jc, tc, jp, tp = models
    jdt = {"bf16": jnp.bfloat16, "e4m3": jnp.float8_e4m3fn}[kv]
    tdt = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn}[kv]
    jeng = jpe.PagedEngine(jp, jc, _engine_cfg(jpe, jdt))
    teng = tpe.PagedEngine(tp, tc, _engine_cfg(tpe, tdt), device="cpu")
    jreqs = [jeng.add_request(p, JSamplingParams(max_new_tokens=MAX_NEW)) for p in _prompts(jc)]
    treqs = [teng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW)) for p in _prompts(tc)]
    jeng.run()
    teng.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(r.done and r.error is None and len(r.output) == MAX_NEW for r in treqs)
    assert teng.pages_in_use == jeng.pages_in_use == 0
    assert teng.k_pages.dtype == tdt


def _run(eng, prompts, max_new=MAX_NEW, **sp):
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=max_new, **sp)) for p in prompts]
    eng.run()
    return reqs


def test_burst_matches_per_step_and_pages_are_reused(models):
    _, tc, _, tp = models
    prompts = _prompts(tc, (7, PAGE + 3, 30))
    burst = tpe.PagedEngine(tp, tc, _engine_cfg(tpe, "fp8", decode_burst=32), device="cpu")
    step = tpe.PagedEngine(tp, tc, _engine_cfg(tpe, "fp8"), device="cpu")
    seen = []
    orig = burst._run_decode_burst
    burst._run_decode_burst = lambda *a: (seen.append(a[-1]), orig(*a))[1]
    got, want = _run(burst, prompts, max_new=20), _run(step, prompts, max_new=20)
    assert [r.output for r in got] == [r.output for r in want]
    assert max(seen) > 1  # bursts did run
    assert burst.pages_in_use == step.pages_in_use == 0
    # The third request reused pages freed by the first two.
    assert burst.allocator.num_free == burst.ecfg.num_pages - 1


def test_pool_exhaustion_queues_and_overlong_is_rejected(models):
    _, tc, _, tp = models
    # 5 usable pages; each request holds 2 (PAGE + 2 tokens + 6 new), so two
    # run at once and the third waits although a slot is free.
    eng = tpe.PagedEngine(tp, tc, _engine_cfg(tpe, "fp8", max_slots=3, num_pages=6),
                          device="cpu")
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW))
            for p in _prompts(tc, (PAGE + 2,) * 3)]
    long = eng.add_request(np.arange(1, 2 * PAGE + 2, dtype=np.int32),
                           SamplingParams(max_new_tokens=2))  # over the largest bucket
    eng.step()
    assert eng.pages_in_use == 4 and eng.slot_req[2] is None and len(eng.waiting) == 2
    done = eng.run()
    assert all(r.done and r.error is None and len(r.output) == MAX_NEW for r in reqs)
    assert long.done and "rejected" in long.error and not long.output
    assert {r.request_id for r in done} == {r.request_id for r in reqs + [long]}
    assert eng.pages_in_use == 0
    with pytest.raises(ValueError, match="multiple of page_size"):
        tpe.PagedEngineConfig(page_size=PAGE, prefill_buckets=(24,))


class BodySteps(tpe.PagedEngine):
    """Runs the step the CUDA graph captures, eagerly over its static
    buffers (tokens, lengths, block tables), where the card would replay it."""

    def _run_decode_burst(self, toks, tables, lens, steps):
        self._toks.copy_(toks)
        self._tables.copy_(tables)
        self._lens.copy_(lens)
        self._row.zero_()
        for _ in range(steps):
            self._graph_step()
        return self._burst_out[:steps].numpy().copy(), self._logits


def test_graph_step_body_matches_the_loop(models):
    _, tc, _, tp = models
    prompts = _prompts(tc, (7, PAGE + 3, 30))
    want = _run(tpe.PagedEngine(tp, tc, _engine_cfg(tpe, "fp8", decode_burst=32), device="cpu"),
                prompts, max_new=20)
    body = BodySteps(tp, tc, _engine_cfg(tpe, "fp8", decode_burst=32), device="cpu")
    got = _run(body, prompts, max_new=20)
    assert [r.output for r in got] == [r.output for r in want]
    assert body.pages_in_use == 0
