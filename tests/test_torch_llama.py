"""The port's Llama forward against the JAX package's on debug configs.

Weights are made by the JAX package from a seed, carried across as numpy
through ``params_from_numpy``, and both forwards run on the CPU (the JAX
attention through ``attention_ref``, its arena kernel in interpret mode; the
port through the kernels' plain versions).

Tolerances: with float32 weights and float32 compute both sides do the same
float32 arithmetic in other orders (rtol 1e-4). In bf16 compute, the two
frameworks' transcendentals (rsqrt, sigmoid, exp) and sum orders differ in
the last float32 bits, which now and then flips a bf16 rounding (2^-8
relative) of an activation; through two layers that moves logits of
magnitude ~1 by up to ~1e-2, so bf16 logits are held to atol 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu.quant import LAYERWISE as J_LAYERWISE
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import config as tconfig
from llm_fp8_tpu_torch.models import llama as tllama
from llm_fp8_tpu_torch.quant import LAYERWISE as T_LAYERWISE

BF16_ATOL = 2e-2

# The JAX side jitted: eager dispatch (and the arena kernel in eager
# interpret mode) costs several times the compile.
jax_forward = jax.jit(jllama.forward, static_argnames=("cfg", "compute_dtype", "return_kv"))
jax_decode_arena = jax.jit(jllama.forward_decode_arena, static_argnames=("cfg",))


def numpy_tree(tree):
    """JAX params → numpy arrays, QTensors as dicts of their fields."""
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _configs(name):
    jc = dataclasses.replace(jconfig.get_config(name), num_layers=2)
    tc = dataclasses.replace(tconfig.get_config(name), num_layers=2)
    return jc, tc


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ["debug-tiny", "debug-small"])
def test_forward_f32_matches_jax(name):
    jc, tc = _configs(name)
    jp = jllama.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(numpy_tree(jp))
    toks = _tokens(jc, 2, 12)
    lens = np.asarray([12, 7], np.int32)
    jl, (jk, jv) = jax_forward(jp, jnp.asarray(toks), jc, kv_lens=jnp.asarray(lens),
                                  compute_dtype=jnp.float32, return_kv=True)
    tl, (tk, tv) = tllama.forward(tp, torch.from_numpy(toks), tc,
                                  kv_lens=torch.from_numpy(lens),
                                  compute_dtype=torch.float32, return_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


def _layerwise(name):
    jc, tc = _configs(name)
    jp = jllama.quantize_params(
        jllama.init_params(jc, jax.random.PRNGKey(1), dtype=jnp.bfloat16), J_LAYERWISE)
    return jc, tc, jp, params_from_numpy(numpy_tree(jp))


@pytest.mark.parametrize("name", ["debug-tiny", "debug-small"])
def test_forward_layerwise_fp8_matches_jax(name):
    jc, tc, jp, tp = _layerwise(name)
    assert tp["layers"]["wqkv"].qvalue.dtype == torch.float8_e4m3fn
    toks = _tokens(jc, 2, 16, seed=1)
    lens = np.asarray([16, 9], np.int32)
    jl, (jk, _) = jax_forward(jp, jnp.asarray(toks), jc, kv_lens=jnp.asarray(lens),
                                 return_kv=True)
    tl, (tk, _) = tllama.forward(tp, torch.from_numpy(toks), tc,
                                 kv_lens=torch.from_numpy(lens), return_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk.astype(jnp.float32)),
                               rtol=0, atol=BF16_ATOL)


def test_forward_with_cache_prefill_then_decode_matches_jax():
    """The generic KVCache path: prefill into a bf16 cache, then one decode
    step at per-sequence positions."""
    jc, tc, jp, tp = _layerwise("debug-tiny")
    B, S, max_len = 2, 10, 32
    toks = _tokens(jc, B, S, seed=2)
    lens = np.asarray([10, 6], np.int32)
    jcache = jllama.init_kv_cache(jc, B, max_len)
    tcache = tllama.init_kv_cache(tc, B, max_len, device="cpu")
    jl, jcache = jax_forward(jp, jnp.asarray(toks), jc, cache=jcache, start_pos=0,
                                kv_lens=jnp.asarray(lens))
    tl, tcache = tllama.forward(tp, torch.from_numpy(toks), tc, cache=tcache, start_pos=0,
                                kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=BF16_ATOL)
    nxt = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)[:, None]
    jl, jcache = jax_forward(jp, jnp.asarray(nxt), jc, cache=jcache,
                                start_pos=jnp.asarray(lens), kv_lens=jnp.asarray(lens + 1))
    tl, tcache = tllama.forward(tp, torch.from_numpy(nxt), tc, cache=tcache,
                                start_pos=torch.from_numpy(lens),
                                kv_lens=torch.from_numpy(lens + 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=BF16_ATOL)
    np.testing.assert_array_equal(tcache.lens.numpy(), np.asarray(jcache.lens))


@pytest.mark.parametrize("name", ["debug-tiny", "debug-small"])
def test_forward_decode_arena_three_steps_matches_jax(name):
    """Prefill, fp8 arena, then three decode steps through the arena kernel
    (JAX: Pallas interpret mode; port: K2's plain version). Both sides start
    from the same arena codes (the JAX arena transposed) and are fed the same
    tokens."""
    jc, tc, jp, tp = _layerwise(name)
    B, S_arena = 2, 128
    toks = _tokens(jc, B, 12, seed=3)
    lens = np.asarray([12, 5], np.int32)
    jl, (jk, jv) = jax_forward(jp, jnp.asarray(toks), jc, kv_lens=jnp.asarray(lens),
                                  return_kv=True)
    L, Hk, Dh = jc.num_layers, jc.num_kv_heads, jc.head_dim

    def arena(new):  # [L, B, 12, Hk, Dh] -> lane-major fp8 arena [L, B, Hk, Dh, S]
        a = jnp.zeros((L, B, Hk, Dh, S_arena), jnp.float8_e4m3fn)
        nt = jnp.clip(new.astype(jnp.float32).transpose(0, 1, 3, 4, 2), -448, 448)
        return a.at[..., :new.shape[2]].set(nt.astype(jnp.float8_e4m3fn))

    ka, va = arena(jk), arena(jv)
    tka = params_from_numpy(np.ascontiguousarray(np.asarray(ka).transpose(0, 1, 2, 4, 3)))
    tva = params_from_numpy(np.ascontiguousarray(np.asarray(va).transpose(0, 1, 2, 4, 3)))
    nxt = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    pos = lens.copy()
    for _ in range(3):
        jlog, ka, va = jax_decode_arena(jp, jnp.asarray(nxt[:, None]), jc, ka, va,
                                                   jnp.asarray(pos))
        tlog, tka, tva = tllama.forward_decode_arena(tp, torch.from_numpy(nxt[:, None]), tc,
                                                     tka, tva, torch.from_numpy(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=BF16_ATOL)
        nxt = np.asarray(jlog)[:, 0].argmax(-1).astype(np.int32)
        pos = pos + 1


def test_quantize_params_matches_jax_codes():
    jc, tc = _configs("debug-small")
    jp = jllama.init_params(jc, jax.random.PRNGKey(2), dtype=jnp.bfloat16)
    tq = tllama.quantize_params(params_from_numpy(numpy_tree(jp)), T_LAYERWISE)
    jq = jllama.quantize_params(jp, J_LAYERWISE)
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        np.testing.assert_array_equal(
            tq["layers"][name].qvalue.view(torch.uint8).numpy(),
            np.asarray(jq["layers"][name].qvalue).view(np.uint8))
        np.testing.assert_array_equal(tq["layers"][name].scale.numpy(),
                                      np.asarray(jq["layers"][name].scale))


ROPE_SCALINGS = {
    "none": None,
    "llama3": dict(rope_type="llama3", factor=32.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position_embeddings=8192),
    "yarn": dict(rope_type="yarn", factor=4.0, original_max_position_embeddings=4096,
                 mscale=0.707, mscale_all_dim=0.707),
    "yarn_plain": dict(rope_type="yarn", factor=8.0, original_max_position_embeddings=2048),
    "linear": dict(rope_type="linear", factor=2.0),
}


@pytest.mark.parametrize("name", list(ROPE_SCALINGS))
def test_rotary_matches_jax(name):
    """Frequencies, cos/sin tables (YaRN's attention scaling included) and the
    rotate-half application, float32 on both sides."""
    from llm_fp8_tpu.ops import rotary as jrot
    from llm_fp8_tpu_torch.ops import rotary as trot

    scaling = ROPE_SCALINGS[name]
    jf = np.asarray(jrot.rope_frequencies(64, 500000.0, scaling))
    tf = trot.rope_frequencies(64, 500000.0, scaling)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-6)
    pos = np.asarray([[0, 5, 4095], [17, 9000, 123]], np.int32)
    jc, js = jrot.rope_cos_sin(jnp.asarray(pos), jnp.asarray(jf), scaling)
    tc, ts = trot.rope_cos_sin(torch.from_numpy(pos), tf, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        trot.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jrot.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-5)


def test_rmsnorm_matches_jax():
    from llm_fp8_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
    from llm_fp8_tpu_torch.ops.rmsnorm import rmsnorm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
                               np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(temperature=0.7), dict(top_k=5),
                                dict(top_p=0.8, temperature=1.3),
                                dict(top_k=20, top_p=0.5, temperature=0.5)],
                         ids=["temp", "top_k", "top_p", "all"])
def test_sampling_filters_match_jax(kw):
    """The filtered distribution ``sample`` draws from; the random streams of
    the two frameworks differ, so only the distribution is compared."""
    from llm_fp8_tpu.ops import sampling as jsamp
    from llm_fp8_tpu_torch.ops import sampling as tsamp

    logits = np.random.default_rng(2).standard_normal((3, 50)).astype(np.float32) * 3
    jl = np.asarray(jsamp.filtered_logits(jnp.asarray(logits), **kw))
    tl = tsamp.filtered_logits(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_array_equal(np.isneginf(tl), np.isneginf(jl))
    np.testing.assert_allclose(tl[np.isfinite(tl)], jl[np.isfinite(jl)], rtol=1e-6)
    np.testing.assert_allclose(tsamp.filtered_probs(torch.from_numpy(logits), **kw).numpy(),
                               np.asarray(jsamp.filtered_probs(jnp.asarray(logits), **kw)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tsamp.greedy(torch.from_numpy(logits)).numpy(),
                                  np.asarray(jsamp.greedy(jnp.asarray(logits))))
