"""The MoE family in the port (``models/moe.py``: Mixtral and Qwen3-MoE)
against the JAX package's, on the CPU. The JAX side runs its reference
attention (``attn_impl="ref"``), never Pallas interpret mode.

* ``moe_forward`` at debug-mixtral and debug-qwen3moe against JAX's on the
  same numpy weights: cache-less in float32 within 1e-5 of the largest
  |logit| (also with routing groups of 4 tokens and capacity factor 1, where
  assignments overflow and drop), with the aux loss within 1e-6; in bf16
  within 2e-2 absolute (the Llama family's bf16 limit) at every position
  before a sequence's first routing flip. Top-k routing is discontinuous:
  bf16 roundings in another order move a router probability by ~1e-3, and
  where two experts' probabilities lie closer than that the two sides pick
  different experts (seen at ~4% of token-layers of these near-uniform
  random routers). Each side's routes are recorded; a flipped token changes
  its own row and, through attention, the later rows of its sequence, so
  those rows are not compared. Every flip must come at a margin under 5e-3
  (a near-tie), and at least half the rows must be compared.
* A prefill of two ragged prompts into a ``KVCache`` and two decode steps
  (lossless, as serving runs), in float32 (1e-5 of the largest |logit|, and
  equal to the cache-less forward over the same text at full capacity).
* The dispatch against JAX's ``_moe_mlp``/``dispatch_experts`` in float32:
  forced overflow at capacity factor 0.5 (the first two tokens keep expert
  0, the rest get a zero delta; JAX ``tests/test_moe.py``), padding rows
  that claim no capacity, planted ties (a zero router: every probability
  equal, the lower index first, slot-major priority), several groups; the
  aux loss with and without a mask against JAX's and HF's
  ``load_balancing_loss_func``, and uniform probabilities giving K.
* ``bmm_f32``: a float32 product of bf16 values, the gradients in the
  operands' dtypes as JAX's einsum VJP.
* ``quantize_moe_params`` under LAYERWISE, int8 and mxfp8: codes and scales
  bit for bit with JAX's (4-D expert QTensors with ``[L, E, 1, N]`` scales,
  or MX blocks along axis 2; an MX code may differ by one step where XLA's
  CPU ``exp2`` makes JAX's scale a hair under its power of two, which the
  test reproduces code for code), the router high precision, the logits of the
  quantized trees within 1e-4 of the largest |logit| (float32 compute);
  ``params_from_numpy`` carries JAX's float32, bf16 and quantized trees.
* The HF packers bit for bit with JAX's and the port's forward on them
  against ``transformers`` Mixtral and Qwen3-MoE models built from configs
  (2e-4, the JAX tests' tolerance); the exports reload in ``transformers``
  with the same logits; ``export_hf`` writes JAX's ``config.json``;
  ``load_zoo_checkpoint`` reads a ``save_pretrained`` directory.
* The registry: ``MOE_REGISTRY`` equals JAX's field for field, the four
  names resolve with ``quantize_moe_params``, ``_pack_fn_for`` picks the
  Qwen3 packer for QK-norm, the init's leaves have JAX's shapes.
The engine, the speculative engine, the trainer and the CLIs:
``tests/test_torch_moe_training.py``.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import moe as jmoe
from llm_fp8_tpu.models import registry as jreg
from llm_fp8_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from llm_fp8_tpu.quant import recipe_set_by_name as jax_recipes
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from llm_fp8_tpu_torch.models import moe as tmoe
from llm_fp8_tpu_torch.models import registry as treg
from llm_fp8_tpu_torch.models.llama import init_kv_cache
from llm_fp8_tpu_torch.quant import QTensor, recipe_set_by_name

# One torch thread per test process (see test_torch_zoo_models.py).
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2
#: A routing flip in bf16 must come at a near-tie: the K-th and (K+1)-th
#: router probabilities closer than this (bf16 noise moves them ~1e-3).
FLIP_MARGIN = 5e-3
NAMES = ("debug-mixtral", "debug-qwen3moe")


def numpy_tree(tree):
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree, is_leaf=lambda x: isinstance(x, np.ndarray))


def cfgs(name, **kw):
    return (dataclasses.replace(jmoe.MOE_REGISTRY[name], **kw),
            dataclasses.replace(tmoe.MOE_REGISTRY[name], **kw))


@functools.lru_cache(maxsize=None)
def weights(name, dtype="float32"):
    """A numpy tree of ``name`` from JAX's init (float32), its norm weights
    drawn at random (the init has them 1), cast to ``dtype`` through JAX."""
    jcfg = jmoe.MOE_REGISTRY[name]
    tree = numpy_tree(jmoe.init_moe_params(jcfg, jax.random.PRNGKey(len(name)),
                                           dtype=jnp.float32))
    rng = np.random.default_rng(len(name))
    for k, v in tree["layers"].items():
        if "norm" in k:
            tree["layers"][k] = (1 + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    return numpy_tree(jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(np.int32)


def _dtypes(kind):
    return (jnp.float32, torch.float32) if kind == "float32" else (jnp.bfloat16, torch.bfloat16)


class Routes:
    """Both sides' router probabilities, layer by layer: JAX's through a
    debug callback in its routed MLP, the port's around ``route``."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        real_j, real_t = jmoe._moe_mlp, tmoe.route

        def jax_mlp(h, w_router, *a, **kw):
            probs = jax.nn.softmax(jnp.dot(h.astype(jnp.float32), w_router.astype(jnp.float32)),
                                   axis=-1)
            jax.debug.callback(lambda p: self.jax.append(np.asarray(p)), probs, ordered=True)
            return real_j(h, w_router, *a, **kw)

        def torch_route(h, w_router, cfg):
            out = real_t(h, w_router, cfg)
            self.torch.append(out[0].detach().float().numpy())
            return out

        monkeypatch.setattr(jmoe, "_moe_mlp", jax_mlp)
        monkeypatch.setattr(tmoe, "route", torch_route)

    def first_flips(self, B, S, K):
        """Per sequence, the first position whose top-K expert set differs
        between the sides in any layer (S where none does); every flip's JAX
        margin between the K-th and (K+1)-th probabilities must be a
        near-tie."""
        first = np.full(B, S)
        assert len(self.jax) == len(self.torch) > 0
        for pj, pt in zip(self.jax, self.torch):
            sj, st = np.argsort(-pj, -1, kind="stable"), np.argsort(-pt, -1, kind="stable")
            flip = np.array([set(a[:K]) != set(b[:K]) for a, b in zip(sj, st)])
            if flip.any():
                srt = np.sort(pj, -1)[:, ::-1]
                margin = (srt[:, K - 1] - srt[:, K])[flip]
                assert margin.max() < FLIP_MARGIN, margin
                for t in np.flatnonzero(flip):
                    first[t // S] = min(first[t // S], t % S)
        return first


def _forward(tree, toks, jcfg, tcfg, kind, **kw):
    jdt, tdt = _dtypes(kind)
    want, _, jaux = jmoe.moe_forward(jax_tree(tree), jnp.asarray(toks), jcfg, compute_dtype=jdt,
                                     attn_impl="ref", return_router_aux=True, **kw)
    got, cache, taux = tmoe.moe_forward(params_from_numpy(tree), torch.from_numpy(toks), tcfg,
                                        compute_dtype=tdt, return_router_aux=True)
    assert cache is None and got.dtype == torch.float32
    return np.asarray(want), got.numpy(), float(jaux), float(taux)


@pytest.mark.parametrize("groups", ["one", "of4_capacity1"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_float32_matches_jax(name, groups):
    kw = {} if groups == "one" else dict(moe_group_size=4, capacity_factor=1.0)
    jcfg, tcfg = cfgs(name, **kw)
    want, got, jaux, taux = _forward(weights(name), _tokens(2, 20), jcfg, tcfg, "float32")
    assert got.shape == (2, 20, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_forward_bf16_matches_jax_before_routing_flips(name, monkeypatch):
    jcfg, tcfg = cfgs(name)
    routes = Routes(monkeypatch)
    toks = _tokens(2, 20, seed=2)
    want, got, jaux, taux = _forward(weights(name, "bfloat16"), toks, jcfg, tcfg, "bf16")
    first = routes.first_flips(2, 20, jcfg.num_experts_per_tok)
    assert first.sum() >= 20, first  # at least half the rows compared
    for b in range(2):
        np.testing.assert_allclose(got[b, :first[b]], want[b, :first[b]], rtol=0,
                                   atol=BF16_ATOL, err_msg=f"sequence {b}")
    np.testing.assert_allclose(taux, jaux, rtol=2e-2)


@pytest.mark.parametrize("name", NAMES)
def test_cache_prefill_and_decode_match_jax_and_the_full_forward(name):
    """Two ragged prompts (20 and 13 tokens of a 24-token prefill) into a
    float32 cache, then two decode steps of a token each."""
    jcfg, tcfg = cfgs(name)
    tree = weights(name)
    B, S, P = 2, 32, 24
    lens = np.asarray([20, 13], np.int32)
    toks = _tokens(B, P, seed=1)
    jp, tp = jax_tree(tree), params_from_numpy(tree)
    jc = jax_init_kv_cache(jcfg, B, S, dtype=jnp.float32)
    tc = init_kv_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    kw = dict(attn_impl="ref", compute_dtype=jnp.float32)
    jl, jc = jmoe.moe_forward(jp, jnp.asarray(toks), jcfg, cache=jc, start_pos=0,
                              kv_lens=jnp.asarray(lens), **kw)
    tl, tc = tmoe.moe_forward(tp, torch.from_numpy(toks), tcfg, cache=tc, start_pos=0,
                              kv_lens=torch.from_numpy(lens), compute_dtype=torch.float32)
    rows_j = [np.asarray(jl)[b, :lens[b]] for b in range(B)]
    rows_t = [tl.numpy()[b, :lens[b]] for b in range(B)]
    nxt = np.asarray([[7], [11]], np.int32)
    for step in range(2):
        pos = lens + step
        jl, jc = jmoe.moe_forward(jp, jnp.asarray(nxt), jcfg, cache=jc,
                                  start_pos=jnp.asarray(pos), kv_lens=jnp.asarray(pos + 1), **kw)
        tl, tc = tmoe.moe_forward(tp, torch.from_numpy(nxt), tcfg, cache=tc,
                                  start_pos=torch.from_numpy(pos),
                                  kv_lens=torch.from_numpy(pos + 1), compute_dtype=torch.float32)
        rows_j.append(np.asarray(jl)[:, 0])
        rows_t.append(tl.numpy()[:, 0])
        nxt = nxt + 3
    assert torch.equal(tc.lens, torch.tensor(np.asarray(jc.lens)))
    top = max(np.abs(r).max() for r in rows_j)
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL * top)
    # The cached steps (lossless) equal the cache-less forward at full capacity.
    _, full_cfg = cfgs(name, capacity_factor=-1.0)
    for b in range(B):
        text = np.concatenate([toks[b, :lens[b]], [7 + 3 * i + 4 * b for i in range(2)]])
        full = tmoe.moe_forward(tp, torch.from_numpy(text[None].astype(np.int32)), full_cfg,
                                compute_dtype=torch.float32)[0][0]
        np.testing.assert_allclose(rows_t[b], full[:lens[b]].numpy(), rtol=0, atol=F32_TOL * top)
        for step in range(2):
            np.testing.assert_allclose(rows_t[B + step][b], full[lens[b] + step].numpy(),
                                       rtol=0, atol=F32_TOL * top)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _expert_weights(cfg, seed=1):
    p = numpy_tree(jmoe.init_moe_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    return p["layers"]["w_gate_up"][0].copy(), p["layers"]["w_down"][0].copy()


def _mlp_both(jcfg, tcfg, h, w_router, gu, dn, mask=None, lossless=False):
    jy, jaux = jmoe._moe_mlp(jnp.asarray(h), jnp.asarray(w_router), jnp.asarray(gu),
                             jnp.asarray(dn), jcfg, lossless=lossless,
                             token_mask=None if mask is None else jnp.asarray(mask))
    ty, taux = tmoe._moe_mlp(torch.from_numpy(h), torch.from_numpy(w_router),
                             torch.from_numpy(gu), torch.from_numpy(dn), tcfg, lossless=lossless,
                             token_mask=None if mask is None else torch.from_numpy(mask))
    return np.asarray(jy), ty.numpy(), float(jaux), float(taux)


def test_forced_overflow_drops_like_jax():
    """Every token on expert 0 at capacity 2 (T 8, K 1, E 2, factor 0.5):
    the first two keep it, the rest get a zero delta."""
    jcfg, tcfg = cfgs("debug-mixtral", capacity_factor=0.5, num_experts=2,
                      num_experts_per_tok=1)
    D = jcfg.hidden_size
    h = (np.abs(np.random.default_rng(0).normal(size=(8, D))) + 0.1).astype(np.float32)
    w_router = np.zeros((D, 2), np.float32)
    w_router[0, 0] = 100.0
    gu, dn = _expert_weights(jcfg)
    jy, ty, jaux, taux = _mlp_both(jcfg, tcfg, h, w_router, gu, dn)
    gate, up = np.split(h @ gu[0], 2, axis=-1)
    dense = (gate / (1 + np.exp(-gate)) * up) @ dn[0]
    np.testing.assert_allclose(ty[:2], dense[:2], rtol=1e-5, atol=1e-5)
    assert not ty[2:].any()
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    assert taux == pytest.approx(jaux, rel=1e-6)
    assert tmoe.expert_capacity(8, 1, 2, 0.5, False) == 2
    assert tmoe.expert_capacity(8, 1, 2, 0.5, True) == 8
    assert tmoe.expert_capacity(8, 1, 2, -1.0, False) == 8


def test_padding_claims_no_capacity_and_groups_match_jax():
    """Capacity 2 an expert in groups of 6 (T 12, K 2, E 4, factor 1): the
    padding rows (mask 0) would take slots if they claimed any; JAX's and
    the port's outputs equal, the padding rows zero, and unmasking them
    changes the real rows' drops."""
    jcfg, tcfg = cfgs("debug-mixtral", moe_group_size=6, capacity_factor=1.0)
    D = jcfg.hidden_size
    rng = np.random.default_rng(1)
    h = rng.normal(size=(12, D)).astype(np.float32)
    w_router = rng.normal(0, 0.5, (D, 4)).astype(np.float32)
    gu, dn = _expert_weights(jcfg)
    mask = np.ones(12, np.float32)
    mask[[0, 1, 6, 7]] = 0  # padding first in each group: it would win slots
    jy, ty, jaux, taux = _mlp_both(jcfg, tcfg, h, w_router, gu, dn, mask=mask)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    assert taux == pytest.approx(jaux, rel=1e-6)
    assert not ty[mask == 0].any()
    _, unmasked, _, _ = _mlp_both(jcfg, tcfg, h, w_router, gu, dn)
    assert not np.allclose(unmasked[mask == 1], ty[mask == 1])
    # Lossless keeps every assignment: each real row as the full-capacity one.
    jy, ty, _, _ = _mlp_both(jcfg, tcfg, h, w_router, gu, dn, mask=mask, lossless=True)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)


def test_planted_ties_route_the_lower_index_first_like_jax():
    """A zero router: every probability 1/E, so every token's top-2 is
    experts (0, 1) in that order; at capacity 3 a group of 8 keeps the first
    three tokens' first choices and the first three's second (slot-major),
    exactly as JAX."""
    jcfg, tcfg = cfgs("debug-mixtral", capacity_factor=0.75, moe_group_size=8)
    D = jcfg.hidden_size
    h = np.random.default_rng(2).normal(size=(16, D)).astype(np.float32)
    w_router = np.zeros((D, 4), np.float32)
    probs, topv, topi = tmoe.route(torch.from_numpy(h), torch.from_numpy(w_router), tcfg)
    assert torch.equal(topi, torch.tensor([[0, 1]] * 16))
    assert torch.equal(topv, torch.full((16, 2), 0.5))
    jv, ji = jax.lax.top_k(jnp.full((16, 4), 0.25), 2)
    assert np.array_equal(np.asarray(ji), topi.numpy())
    # torch.topk itself makes no promise of that order; the port's top_k does.
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.3, 0.3, 0.1, 0.3]])
    assert tmoe.top_k(p, 2)[1].tolist() == [[1, 2], [0, 1]]
    gu, dn = _expert_weights(jcfg)
    jy, ty, jaux, taux = _mlp_both(jcfg, tcfg, h, w_router, gu, dn)
    assert tmoe.expert_capacity(8, 2, 4, 0.75, False) == 3
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    kept = np.abs(ty).sum(-1) > 0
    assert kept.tolist() == ([True] * 3 + [False] * 5) * 2
    assert taux == pytest.approx(2.0) and jaux == pytest.approx(2.0)


def test_load_balance_loss_matches_jax_and_hf():
    from transformers.models.mixtral.modeling_mixtral import load_balancing_loss_func

    rng = np.random.default_rng(3)
    E, K, B, S = 8, 2, 3, 10
    logits = rng.normal(size=(B * S, E)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(logits), -1)
    topi = tmoe.top_k(probs, K)[1]
    mask = np.ones((B, S), np.int64)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    for m in (None, mask):
        got = float(tmoe.load_balance_loss(probs, topi, E, None if m is None
                                           else torch.from_numpy(m.reshape(-1))))
        want = float(jmoe.load_balance_loss(jnp.asarray(probs.numpy()), jnp.asarray(topi.numpy()),
                                            E, None if m is None else jnp.asarray(m.reshape(-1))))
        hf = float(load_balancing_loss_func(
            (torch.from_numpy(logits),), E, K,
            attention_mask=None if m is None else torch.from_numpy(m)))
        assert got == pytest.approx(want, rel=1e-6) and got == pytest.approx(hf, rel=1e-5)
    uniform = torch.full((B * S, E), 1.0 / E)
    assert float(tmoe.load_balance_loss(uniform, topi, E)) == pytest.approx(K, rel=1e-6)


def test_bmm_f32_is_a_float32_product_of_bf16_values_with_jax_gradients():
    g = torch.Generator().manual_seed(4)
    a = torch.randn((3, 5, 64), generator=g).bfloat16().requires_grad_(True)
    b = torch.randn((3, 64, 7), generator=g).bfloat16().requires_grad_(True)
    y = tmoe.bmm_f32(a, b)
    assert y.dtype == torch.float32
    assert torch.equal(y, torch.bmm(a.float(), b.float()))
    cot = torch.randn((3, 5, 7), generator=g)
    ga, gb = torch.autograd.grad(y, (a, b), cot)
    assert ga.dtype == gb.dtype == torch.bfloat16
    _, vjp = jax.vjp(lambda x, w: jnp.einsum("ecd,edf->ecf", x, w,
                                             preferred_element_type=jnp.float32),
                     jnp.asarray(a.detach().float().numpy()).astype(jnp.bfloat16),
                     jnp.asarray(b.detach().float().numpy()).astype(jnp.bfloat16))
    ja, jb = vjp(jnp.asarray(cot.numpy()))
    np.testing.assert_allclose(ga.float().numpy(), np.asarray(ja.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(jb.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


# --------------------------------------------------------------------------
# quantized trees
# --------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _mx_codes_as_jax(w, got, want):
    """MX codes against JAX's: XLA's CPU ``exp2`` is one ulp low at some
    integer exponents (2^-13 gives 1.2207025e-4), so JAX divides by a scale a
    hair under the power of two it stores, and an element within ~1e-7 of an
    e4m3 rounding midpoint rounds up there. The port divides by the exact
    power of two (the stored E8M0 value). Every code equals the port's exact
    division, JAX's equals that same division by its ``exp2``, and the two
    differ only where that scale is inexact, by one e4m3 step."""
    scale = got.spread_scale().numpy()
    exact = np.clip(w / scale, -448, 448)
    assert torch.equal(got.qvalue, tmoe.quantize(torch.from_numpy(exact), got.fmt,
                                                 scale=torch.ones(()), flush_subnormal=True
                                                 ).qvalue)
    xla = np.asarray(jnp.exp2(jnp.asarray(np.log2(scale))))
    jq = jnp.asarray(np.clip(w / xla, -448, 448)).astype(jnp.float8_e4m3fn)
    jq = np.asarray(jnp.where(jnp.abs(jq.astype(jnp.float32)) < 2.0 ** -6, 0, jq)
                    .astype(jnp.float32))
    np.testing.assert_array_equal(jq, want.float().numpy())
    differ = got.qvalue.float().numpy() != jq
    assert (xla != scale)[differ].all()
    assert differ.sum() <= 1e-4 * differ.size


@pytest.mark.parametrize("recipe", ["default", "int8", "mxfp8"])
def test_quantize_moe_params_matches_jax_bit_for_bit(recipe, monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "0")
    name = "debug-qwen3moe"
    jcfg, tcfg = cfgs(name)
    tree = weights(name)
    jq_tree = jmoe.quantize_moe_params(jax_tree(tree), jax_recipes(recipe))
    jq = numpy_tree(jq_tree)
    got = tmoe.quantize_moe_params(params_from_numpy(tree), recipe_set_by_name(recipe))
    carried = params_from_numpy(jq)
    quantized = set()
    for leaf, w in jq["layers"].items():
        for g in (got["layers"][leaf], carried["layers"][leaf]):
            if isinstance(w, dict):
                quantized.add(leaf)
                assert isinstance(g, QTensor) and g.fmt.name == w["fmt"], leaf
                assert (g.block_size, g.block_axis) == (w["block_size"], w["block_axis"]), leaf
                assert torch.equal(_bits(g.scale), _bits(tensor_from_numpy(w["scale"]))), leaf
                if g is got["layers"][leaf] and g.block_size is not None:
                    _mx_codes_as_jax(tree["layers"][leaf], g, tensor_from_numpy(w["qvalue"]))
                else:
                    assert torch.equal(_bits(g.qvalue),
                                       _bits(tensor_from_numpy(w["qvalue"]))), leaf
            else:
                assert torch.equal(_bits(g), _bits(tensor_from_numpy(w))), leaf
    assert quantized == {"wqkv", "wo", "w_gate_up", "w_down"}  # the router stays
    gu = got["layers"]["w_gate_up"]
    assert gu.qvalue.shape == (2, 4, 128, 128)
    if recipe != "mxfp8":
        assert gu.scale.shape == (2, 4, 1, 128)
    toks = _tokens(1, 12, seed=4)
    want, _ = jmoe.moe_forward(jq_tree, jnp.asarray(toks), jcfg, compute_dtype=jnp.float32,
                               attn_impl="ref")
    out, _ = tmoe.moe_forward(carried, torch.from_numpy(toks), tcfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_fp8native_layout_covers_the_projections_only(monkeypatch):
    """On the fp8native route ``wqkv``/``wo`` codes are K-major (padded) for
    the fp8 products; the expert codes stay row-major, as JAX holds them."""
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "1")
    monkeypatch.delenv("LLM_FP8_QDOT", raising=False)
    tree = params_from_numpy(weights("debug-mixtral"))
    q = tmoe.quantize_moe_params(tree, recipe_set_by_name("default"))
    assert q["layers"]["wqkv"].qvalue.stride(-2) == 1
    assert q["layers"]["w_gate_up"].qvalue.is_contiguous()
    assert q["layers"]["w_down"].qvalue.is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_jax_moe_trees(dtype):
    tree = weights("debug-mixtral", dtype)
    got = params_from_numpy(tree)
    for k, v in tree["layers"].items():
        t = got["layers"][k]
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == v.shape, k
        assert torch.equal(_bits(t), _bits(tensor_from_numpy(v))), k
    assert torch.equal(_bits(got["lm_head"]), _bits(tensor_from_numpy(tree["lm_head"])))


# --------------------------------------------------------------------------
# registry and HF
# --------------------------------------------------------------------------

def test_registry_matches_jax_and_resolves_the_four_names():
    assert set(tmoe.MOE_REGISTRY) == set(jmoe.MOE_REGISTRY)
    for name, j in jmoe.MOE_REGISTRY.items():
        t = tmoe.MOE_REGISTRY[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.num_params() == j.num_params(), name
        e = treg.resolve_model(name)
        assert e.cfg is t and e.forward_fn is tmoe.moe_forward
        assert e.init_fn is tmoe.init_moe_params and e.quantize_fn is tmoe.quantize_moe_params
        assert name in treg.zoo_model_names()
        want = "pack_qwen3_moe_state_dict" if t.qk_norm else "pack_mixtral_state_dict"
        assert treg._pack_fn_for(name).__name__ == want == jreg._pack_fn_for(name).__name__
    assert "MoE" not in treg.UNPORTED_FAMILIES
    for name in NAMES:
        init = tmoe.init_moe_params(tmoe.MOE_REGISTRY[name], device="cpu", seed=0)
        want = numpy_tree(jmoe.init_moe_params(jmoe.MOE_REGISTRY[name], jax.random.PRNGKey(0)))
        assert set(init) == set(want) and set(init["layers"]) == set(want["layers"])
        for k, v in init["layers"].items():
            assert tuple(v.shape) == want["layers"][k].shape and v.dtype == torch.bfloat16, k


def _hf_model(name, seed=0):
    import transformers

    cfg = tmoe.MOE_REGISTRY[name]
    common = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
                  num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
                  num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                  num_experts_per_tok=cfg.num_experts_per_tok, rope_theta=cfg.rope_theta,
                  rms_norm_eps=cfg.rms_eps, max_position_embeddings=cfg.max_position_embeddings,
                  tie_word_embeddings=cfg.tie_word_embeddings, attention_dropout=0.0,
                  attn_implementation="eager")
    torch.manual_seed(seed)
    if cfg.qk_norm:
        model = transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
            intermediate_size=cfg.intermediate_size * 4,
            moe_intermediate_size=cfg.intermediate_size, num_experts=cfg.num_experts,
            norm_topk_prob=cfg.norm_topk_prob, decoder_sparse_step=1, mlp_only_layers=[],
            attention_bias=False, **common))
    else:
        model = transformers.MixtralForCausalLM(transformers.MixtralConfig(
            intermediate_size=cfg.intermediate_size, num_local_experts=cfg.num_experts,
            sliding_window=None, **common))
    with torch.no_grad():  # norms away from 1
        for n, p in model.named_parameters():
            if "norm" in n:
                p.normal_(1.0, 0.2)
    return model.eval()


@pytest.mark.parametrize("name", NAMES)
def test_packer_matches_jax_and_transformers(name):
    jcfg, tcfg = cfgs(name, capacity_factor=-1.0)  # HF never drops
    model = _hf_model(name)
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    jpack = jmoe.pack_qwen3_moe_state_dict if jcfg.qk_norm else jmoe.pack_mixtral_state_dict
    want = numpy_tree(jpack({k: jnp.asarray(v) for k, v in sd.items()}, jcfg, dtype=jnp.float32))
    got = treg._pack_fn_for(name)(sd, tcfg, dtype=torch.float32, device="cpu")
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), w, err_msg=k)
    tokens = (torch.arange(24).reshape(2, 12) * 7) % tcfg.vocab_size
    with torch.no_grad():
        hf = model(tokens).logits.float()
    ours, _ = tmoe.moe_forward(got, tokens, tcfg, compute_dtype=torch.float32)
    torch.testing.assert_close(ours, hf, rtol=2e-4, atol=2e-4)
    with pytest.raises(KeyError, match="model.norm.weight"):
        treg._pack_fn_for(name)({k: v for k, v in sd.items() if k != "model.norm.weight"},
                                tcfg, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_export_reloads_in_transformers_and_export_hf_writes_jax_config(name, tmp_path):
    from llm_fp8_tpu.training.checkpoint import export_hf as jax_export_hf
    from llm_fp8_tpu_torch.training import export_hf

    jcfg, tcfg = cfgs(name, capacity_factor=-1.0)
    params = params_from_numpy(weights(name))
    export = tmoe.export_qwen3_moe_state_dict if tcfg.qk_norm else tmoe.export_mixtral_state_dict
    sd = export(params, tcfg)
    jexport = (jmoe.export_qwen3_moe_state_dict if jcfg.qk_norm
               else jmoe.export_mixtral_state_dict)
    jsd = jexport(jax_tree(weights(name)), jcfg)
    assert set(sd) == set(jsd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    model = _hf_model(name)
    missing, unexpected = model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                                strict=False)
    assert not unexpected and all("inv_freq" in m for m in missing)
    tokens = (torch.arange(10)[None] * 7) % tcfg.vocab_size
    with torch.no_grad():
        hf = model(tokens).logits.float()
    ours, _ = tmoe.moe_forward(params, tokens, tcfg, compute_dtype=torch.float32)
    torch.testing.assert_close(ours, hf, rtol=2e-4, atol=2e-4)
    export_hf(params, tcfg, str(tmp_path / "torch"))
    jax_export_hf(jax_tree(weights(name)), jcfg, str(tmp_path / "jax"))
    got, want = (json.loads((tmp_path / s / "config.json").read_text()) for s in ("torch", "jax"))
    assert got == want
    # The written directory reads back through the registry, bit for bit.
    back = treg.load_zoo_checkpoint(name, str(tmp_path / "torch"), dtype=torch.float32,
                                    device="cpu")
    for k, v in params["layers"].items():
        assert torch.equal(back["layers"][k], v), k


@pytest.mark.parametrize("name", NAMES)
def test_load_zoo_checkpoint_reads_save_pretrained(name, tmp_path):
    model = _hf_model(name, seed=1)
    model.save_pretrained(tmp_path, safe_serialization=True)
    tcfg = tmoe.MOE_REGISTRY[name]
    got = treg.load_zoo_checkpoint(name, str(tmp_path), dtype=torch.float32, device="cpu")
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    want = treg._pack_fn_for(name)(sd, tcfg, dtype=torch.float32, device="cpu")
    for k, v in want["layers"].items():
        assert torch.equal(got["layers"][k], v), k
    assert torch.equal(got["embed"], want["embed"])
