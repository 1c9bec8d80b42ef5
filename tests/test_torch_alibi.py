"""ALiBi in the port against the JAX package: the slopes, the plain
attentions, the plain versions of K2, K3, K5 and K6, and ``debug-baichuan``
end to end (prefill, arena and paged decode, the engine, fp8 training).

JAX's side runs through its plain references (``attention_ref``,
``decode_attention``, the gradient of ``attention_ref``) except for the
arena and paged decode kernels, whose JAX tests run them in Pallas interpret
mode. Tolerances: the float32 references agree to rtol 1e-5 of the largest
value; K3's plain version rounds P to bf16 where ``attention_ref`` does not,
so its bf16 output is held to two bf16 ulps of the largest output (one for P,
one for the output's rounding) and its gradients to the flash-backward tests'
2e-2; the decode kernels' plain versions to one bf16 ulp of their JAX kernel,
as in ``test_torch_attention.py``; model logits to the 2e-2 of
``test_torch_llama.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.kernels.decode_attention import decode_attention_arena as jax_arena
from llm_fp8_tpu.kernels.paged_attention import paged_attention as jax_paged
from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu.ops.attention import alibi_slopes_list as jax_slopes
from llm_fp8_tpu.ops.attention import attention_ref as jax_attention_ref
from llm_fp8_tpu.ops.attention import decode_attention as jax_decode_attention
from llm_fp8_tpu.quant import LAYERWISE as J_LAYERWISE
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu.serving import engine as jengine
from llm_fp8_tpu.serving import paged_engine as jpe
from llm_fp8_tpu_torch.convert import (params_from_numpy, pool_from_numpy, pool_to_numpy,
                                       tensor_from_numpy)
from llm_fp8_tpu_torch.kernels import KERNEL_WRAPPERS
from llm_fp8_tpu_torch.kernels.decode_attention import decode_attention_arena
from llm_fp8_tpu_torch.kernels.flash_attention import flash_attention
from llm_fp8_tpu_torch.kernels.paged_attention import paged_attention
from llm_fp8_tpu_torch.models import config as tconfig
from llm_fp8_tpu_torch.models import llama as tllama
from llm_fp8_tpu_torch.ops.attention import (alibi_slopes_list, attention_ref,
                                             decode_attention, default_alibi_slopes)
from llm_fp8_tpu_torch.serving import engine as tengine
from llm_fp8_tpu_torch.serving import paged_engine as tpe

TOL = 2e-2


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


def numpy_tree(tree):
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("heads", [4, 8, 12, 40])
def test_slopes_equal_jax(heads):
    # 12 and 40 (Baichuan-13B) are not powers of two: the interleaved rule.
    assert alibi_slopes_list(heads) == jax_slopes(heads)
    t = default_alibi_slopes(heads)
    assert t.dtype == torch.float32 and t.tolist() == np.float32(jax_slopes(heads)).tolist()
    assert default_alibi_slopes(heads) is t  # built once per head count and device


REF_CASES = {
    # name: (B, Sq, Sk, Hq, Hk, causal, softcap, q_offset, kv_lens, per-batch slopes)
    "causal": (2, 24, 24, 4, 2, True, None, [0, 0], [24, 17], False),
    "noncausal_q_offset": (2, 8, 40, 4, 2, False, None, [30, 12], [40, 33], True),
    "softcap": (2, 16, 32, 12, 4, True, 5.0, [16, 4], [32, 30], False),
}


def _qkv(rng, B, Sq, Sk, Hq, Hk, D=32):
    return (rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))


@pytest.mark.parametrize("name", list(REF_CASES))
def test_attention_ref_and_flash_plain_match_jax(name):
    B, Sq, Sk, Hq, Hk, causal, softcap, q_off, kv, per_batch = REF_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = _qkv(rng, B, Sq, Sk, Hq, Hk)
    slopes = np.asarray(jax_slopes(Hq), np.float32) * 4  # steep enough to matter at 40 keys
    if per_batch:
        slopes = np.stack([slopes, slopes[::-1]])
    qo, kl = np.asarray(q_off, np.int32), np.asarray(kv, np.int32)
    kw = dict(causal=causal, softcap=softcap)
    want = np.asarray(jax.jit(lambda *a: jax_attention_ref(
        *a, q_offset=jnp.asarray(qo), kv_lens=jnp.asarray(kl), alibi_slopes=jnp.asarray(slopes),
        **kw))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        q_offset=torch.from_numpy(qo), kv_lens=torch.from_numpy(kl),
                        alibi_slopes=torch.from_numpy(slopes), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # K3's plain version (bf16 in, P rounded to bf16) against the same golden
    # on the bf16 values, and its gradients (K6's plain version) against
    # JAX's gradient of the golden.
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))

    @jax.jit
    def golden(q_, k_, v_):
        return jax_attention_ref(q_, k_, v_, q_offset=jnp.asarray(qo), kv_lens=jnp.asarray(kl),
                                 alibi_slopes=jnp.asarray(slopes), **kw)

    ref = np.asarray(golden(*(a.astype(jnp.float32) for a in (qb, kb, vb))))
    tq, tk, tv = (_t(a).requires_grad_() for a in (qb, kb, vb))
    out = flash_attention(tq, tk, tv, q_offset=torch.from_numpy(qo),
                          kv_lens=torch.from_numpy(kl), alibi_slopes=torch.from_numpy(slopes),
                          **kw)
    np.testing.assert_allclose(out.float().detach().numpy(), ref, rtol=0, atol=2 * _ulp(ref))
    do = rng.standard_normal(out.shape).astype(np.float32)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(jnp.asarray(do).astype(jnp.bfloat16)))
    want_g = jax.jit(lambda d, *a: jax.vjp(golden, *a)[1](d))(
        jnp.asarray(do).astype(jnp.bfloat16).astype(jnp.float32),
        *(a.astype(jnp.float32) for a in (qb, kb, vb)))
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w), rtol=2e-2, atol=2e-2)
    assert KERNEL_WRAPPERS["flash_attention"].launches == 0  # CPU: plain version


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    B, S, Hq, Hk = 3, 40, 8, 2
    q, k, v = _qkv(rng, B, 1, S, Hq, Hk)
    slopes = np.asarray(jax_slopes(Hq), np.float32)
    pos, kl = np.asarray([39, 20, 7], np.int32), np.asarray([40, 21, 8], np.int32)
    kw = dict(softcap=4.0)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(pos),
        kv_lens=jnp.asarray(kl), alibi_slopes=jnp.asarray(slopes), **kw))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           q_offset=torch.from_numpy(pos), kv_lens=torch.from_numpy(kl),
                           alibi_slopes=torch.from_numpy(slopes), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("softcap", [None, 3.0])
def test_arena_plain_matches_jax_kernel(softcap):
    """K2's plain version with ALiBi and append, no rotary (as ALiBi models
    decode), e4m3 arena at 12 q heads over 4 kv heads (the interleaved
    slopes in the packed GQA order): output within one bf16 ulp, the
    appended codes bit for bit."""
    rng = np.random.default_rng(11)
    L, B, Hq, Hk, D, S = 2, 3, 12, 4, 32, 128
    ka, va = (jnp.asarray(np.clip(rng.standard_normal((L, B, Hk, D, S)) * 4, -448, 448)
                          .astype(np.float32)).astype(jnp.float8_e4m3fn) for _ in range(2))
    q = jnp.asarray(rng.standard_normal((B, Hq, D)).astype(np.float32)).astype(jnp.bfloat16)
    nk, nv = (jnp.asarray(rng.standard_normal((B, Hk, D)).astype(np.float32))
              .astype(jnp.bfloat16) for _ in range(2))
    lengths = np.asarray([1, 70, S], np.int32)
    slopes = tuple(jax_slopes(Hq))
    ref, ka_j, _ = jax_arena(q, ka, va, jnp.asarray(lengths), 1, new_k=nk, new_v=nv,
                             alibi_slopes=slopes, softcap=softcap, interpret=True)
    port = lambda a: _t(np.ascontiguousarray(np.asarray(a).transpose(0, 1, 2, 4, 3)))  # noqa: E731
    ka_t, va_t = port(ka), port(va)
    out, _, _ = decode_attention_arena(_t(q), ka_t, va_t, torch.from_numpy(lengths), 1,
                                       new_k=_t(nk), new_v=_t(nv), alibi_slopes=slopes,
                                       softcap=softcap)
    np.testing.assert_array_equal(ka_t.view(torch.uint8).numpy(),
                                  port(ka_j).view(torch.uint8).numpy())
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))


def test_paged_plain_matches_jax_kernel():
    rng = np.random.default_rng(12)
    P, L, Hq, Hk, D, page = 10, 2, 8, 4, 32, 16
    kv_scale = 0.5
    kp, vp = (jnp.asarray(np.clip(rng.standard_normal((P, L, Hk, D, page)) / kv_scale, -448,
                                  448).astype(np.float32)).astype(jnp.float8_e4m3fn)
              for _ in range(2))
    tables = np.asarray([[3, 7, 1, 0], [5, 6, 2, 8]], np.int32)
    lengths = np.asarray([33, 64], np.int32)
    q = jnp.asarray(rng.standard_normal((2, Hq, D)).astype(np.float32)).astype(jnp.bfloat16)
    nk, nv = (jnp.asarray(rng.standard_normal((2, Hk, D)).astype(np.float32))
              .astype(jnp.bfloat16) for _ in range(2))
    slopes = tuple(jax_slopes(Hq))
    ref, kp_j, _ = jax_paged(q, kp, vp, jnp.asarray(lengths), jnp.asarray(tables), 1,
                             kv_scale=kv_scale, new_k=nk, new_v=nv, alibi_slopes=slopes,
                             interpret=True)
    kp_t, vp_t = pool_from_numpy(kp), pool_from_numpy(vp)
    out, _, _ = paged_attention(_t(q), kp_t, vp_t, torch.from_numpy(lengths),
                                torch.from_numpy(tables), 1, kv_scale=kv_scale, new_k=_t(nk),
                                new_v=_t(nv), alibi_slopes=slopes)
    np.testing.assert_array_equal(pool_to_numpy(kp_t), np.asarray(kp_j).view(np.uint8))
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=_ulp(ref))


# ---------------------------------------------------------------- debug-baichuan ----


@pytest.fixture(scope="module")
def baichuan():
    jc, tc = jconfig.get_config("debug-baichuan"), tconfig.get_config("debug-baichuan")
    jp = jllama.quantize_params(
        jllama.init_params(jc, jax.random.PRNGKey(6), dtype=jnp.bfloat16), J_LAYERWISE)
    return jc, tc, jp, params_from_numpy(numpy_tree(jp))


def _order(codes):
    """e4m3 codes as integers in value order."""
    return np.where(codes & 0x80, -(codes & 0x7F).astype(int), codes & 0x7F)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


def test_baichuan_prefill_and_arena_decode_match_jax(baichuan):
    """Prefill logits (LAYERWISE fp8 weights, bf16 compute), then three
    decode steps through the arena (JAX: its kernel in interpret mode; the
    port: K2's plain version with the slopes, no rotary)."""
    jc, tc, jp, tp = baichuan
    B, S_arena = 2, 128
    toks = _tokens(jc, B, 12, 7)
    lens = np.asarray([12, 5], np.int32)
    jl, (jk, jv) = jax.jit(jllama.forward, static_argnames=("cfg", "return_kv"))(
        jp, jnp.asarray(toks), jc, kv_lens=jnp.asarray(lens), return_kv=True)
    tl, _ = tllama.forward(tp, torch.from_numpy(toks), tc, kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    L, Hk, Dh = jc.num_layers, jc.num_kv_heads, jc.head_dim

    def arena(new):
        a = jnp.zeros((L, B, Hk, Dh, S_arena), jnp.float8_e4m3fn)
        nt = jnp.clip(new.astype(jnp.float32).transpose(0, 1, 3, 4, 2), -448, 448)
        return a.at[..., :new.shape[2]].set(nt.astype(jnp.float8_e4m3fn))

    ka, va = arena(jk), arena(jv)
    port = lambda a: params_from_numpy(  # noqa: E731
        np.ascontiguousarray(np.asarray(a).transpose(0, 1, 2, 4, 3)))
    tka, tva = port(ka), port(va)
    step = jax.jit(jllama.forward_decode_arena, static_argnames=("cfg",))
    nxt, pos = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32), lens.copy()
    for _ in range(3):
        jlog, ka, va = step(jp, jnp.asarray(nxt[:, None]), jc, ka, va, jnp.asarray(pos))
        tlog, tka, tva = tllama.forward_decode_arena(tp, torch.from_numpy(nxt[:, None]), tc,
                                                     tka, tva, torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL)
        # Layer 0's appended codes bit for bit; later layers' within one e4m3
        # step (their inputs carry the frameworks' bf16 rounding differences).
        got, want = tka.view(torch.uint8).numpy(), port(ka).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got[0], want[0])
        assert np.abs(_order(got) - _order(want)).max() <= 1
        nxt, pos = np.asarray(jlog)[:, 0].argmax(-1).astype(np.int32), pos + 1


def test_baichuan_paged_decode_matches_jax(baichuan):
    jc, tc, jp, tp = baichuan
    rng = np.random.default_rng(8)
    L, Hk, Dh, page = jc.num_layers, jc.num_kv_heads, jc.head_dim, 16
    pool = lambda: jnp.asarray(np.clip(rng.standard_normal(  # noqa: E731
        (10, L, Hk, Dh, page)).astype(np.float32), -448, 448)).astype(jnp.float8_e4m3fn)
    kp, vp = pool(), pool()
    tables = np.asarray([[3, 7, 0, 0], [1, 2, 9, 5]], np.int32)
    lens = np.asarray([20, 40], np.int32)
    toks = rng.integers(1, jc.vocab_size, (2, 1)).astype(np.int32)
    jstep = jax.jit(lambda p, t, k, v, tb, n: jllama.forward_paged(p, t, jc, k, v, tb, n))
    tk, tv = pool_from_numpy(kp), pool_from_numpy(vp)
    for _ in range(2):
        jl, kp, vp = jstep(jp, jnp.asarray(toks), kp, vp, jnp.asarray(tables), jnp.asarray(lens))
        tl, tk, tv = tllama.forward_paged(tp, torch.from_numpy(toks), tc, tk, tv,
                                          torch.from_numpy(tables), torch.from_numpy(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
        toks = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)[:, None]
        lens = lens + 1


def test_baichuan_engines_match_jax_engines_token_for_token(baichuan):
    """Greedy tokens through the arena engine (fp8 KV) and the paged engine
    (e4m3 pool), port against JAX."""
    jc, tc, jp, tp = baichuan
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32) for n in (5, 12, 20)]
    outs = []
    for mod, kw in ((jengine, {}), (tengine, dict(device="cpu"))):
        ecfg = mod.EngineConfig(max_slots=2, max_seq_len=128, prefill_buckets=(32,),
                                kv_dtype="fp8", decode_burst=1)
        eng = mod.Engine(jp if mod is jengine else tp, jc if mod is jengine else tc, ecfg, **kw)
        reqs = [eng.add_request(p, mod.SamplingParams(max_new_tokens=6)) for p in prompts]
        eng.run()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    outs = []
    for mod, kw, dt in ((jpe, {}, jnp.float8_e4m3fn), (tpe, dict(device="cpu"),
                                                       torch.float8_e4m3fn)):
        pcfg = mod.PagedEngineConfig(max_slots=2, num_pages=12, page_size=16,
                                     max_pages_per_seq=4, kv_dtype=dt,
                                     prefill_buckets=(16, 32), decode_burst=1)
        eng = mod.PagedEngine(jp if mod is jpe else tp, jc if mod is jpe else tc, pcfg, **kw)
        sp = jengine.SamplingParams if mod is jpe else tengine.SamplingParams
        reqs = [eng.add_request(p, sp(max_new_tokens=6)) for p in prompts]
        eng.run()
        outs.append([r.output for r in reqs])
        assert eng.pages_in_use == 0
    assert outs[0] == outs[1]


def test_baichuan_fp8_train_gradients_match_jax():
    """One LAYERWISE training forward and backward at 2 layers: the loss and
    the gradients against JAX's, within the fp8 tolerances of
    ``test_torch_training.py``: loss relative 1e-3, gradient norm relative
    2e-2, and each parameter's gradient within the 15% that file holds the
    delayed state to (its first-step fp8 gradients read 2.3-8.2% apart on
    debug-tiny; here 2.3-8.6%)."""
    from llm_fp8_tpu.training import quant_state as jqs
    from llm_fp8_tpu_torch.quant import recipe_set_by_name
    from llm_fp8_tpu_torch.training import quant_state as tqs
    from llm_fp8_tpu.quant import recipe_set_by_name as jrecipes

    jc = dataclasses.replace(jconfig.get_config("debug-baichuan"), vocab_size=256)
    tc = dataclasses.replace(tconfig.get_config("debug-baichuan"), vocab_size=256)
    jp = jllama.init_params(jc, jax.random.PRNGKey(3), dtype=jnp.float32)
    ids = _tokens(jc, 2, 16, 4)
    jrec, trec = jrecipes("default"), recipe_set_by_name("default")

    def jloss(p, sinks):
        logits, _ = jllama.forward_fp8_train(
            p, jnp.asarray(ids), jc, jrec,
            jqs.forward_scales(jqs.init_train_quant_state(jc, jrec), jc), sinks)
        return jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, jnp.asarray(ids)[..., None], -1)[..., 0])

    jl, (jg, _) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jqs.make_sinks(jc))
    tp = params_from_numpy(numpy_tree(jp))
    leaves = [t.requires_grad_() for t in _leaves(tp)]
    sinks = tqs.make_sinks(tc, "cpu")
    logits, _ = tllama.forward_fp8_train(
        tp, torch.from_numpy(ids), tc, trec,
        tqs.forward_scales(tqs.init_train_quant_state(tc, trec, "cpu"), tc, "cpu"), sinks)
    tl = (torch.logsumexp(logits, -1) - logits.gather(
        -1, torch.from_numpy(ids).long()[..., None])[..., 0]).mean()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-3)
    tg = torch.autograd.grad(tl, leaves)
    want = _paths(numpy_tree(jg))
    norm = lambda gs: np.sqrt(sum(float(np.sum(np.square(g))) for g in gs))  # noqa: E731
    np.testing.assert_allclose(norm(g.numpy() for g in tg), norm(w for _, w in want), rtol=2e-2)
    for (path, w), g in zip(want, tg):
        rel = np.linalg.norm(g.float().numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert rel < 0.15, (path, rel)


def _leaves(tree):
    return ([t for k in sorted(tree) for t in _leaves(tree[k])] if isinstance(tree, dict)
            else [tree])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pw for k in sorted(tree) for pw in _paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree, np.float32))]
