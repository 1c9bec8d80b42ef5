"""The MLA family in the port (``models/mla.py``: DeepSeek-V2-Lite and
DeepSeek-V2) against the JAX package's, on the CPU. The JAX side runs its
reference attention (``attn_impl="ref"``), never Pallas interpret mode.

* ``mla_forward`` at debug-mla (direct q, greedy gate) and debug-mla-q
  (low-rank q, group-limited gate, routed scale 2.5) against JAX's on the
  same numpy weights (norms drawn away from 1): cache-less in float32 within
  1e-5 of the largest |logit| (JAX's HF tolerance is 2e-4), also with the
  published yarn rope scaling, the aux loss within 1e-6 relative; in bf16
  within 2e-2 absolute (the MoE family's bf16 limit) at every position
  before a sequence's first routing flip (each side's routes recorded; every
  flip must come at a near-tie, margin under 5e-3, of the top-k or of the
  group choice, and at least half the rows must be compared).
* The latent cache: ``init_kv_cache`` builds JAX's asymmetric ``[L, B, T,
  1, kv_lora_rank]`` / ``[L, B, T, 1, qk_rope_head_dim]`` stores; a prefill
  of two ragged prompts and two decode steps, float32 compute, with
  float32, bf16 and e4m3 caches: the logits within 1e-5 of the largest
  |logit| of JAX's (1e-4 with bf16, 1e-3 with e4m3: a latent on a rounding
  boundary stores one step the other way) and the stored codes equal to
  JAX's; against the cache-less forward over the same text (lossless
  capacity) within 1e-5 with a float32 cache, 2e-2 with bf16 and 0.25 with
  e4m3 (the cache's rounding of the latents: 2^-9 and 2^-4 relative).
* ``deepseek_gate`` greedy and group-limited against JAX's ``_deepseek_gate``
  bit for bit in indices and within 1e-5 relative in weights (the router
  product's float32 sum order), planted ties included
  (a zero router: every probability and every group score equal, the lower
  index first).
* ``quantize_mla_params`` under LAYERWISE, int8 and mxfp8: codes and scales
  bit for bit with JAX's (MX codes as in ``tests/test_torch_moe.py``), the
  router high precision, the logits of the quantized trees within 1e-4 of
  the largest |logit|; ``w_kv_b`` dequantizes to the same logical ``[r,
  H·(dn+dv)]`` on the ``xla`` (row-major) and fp8native (K-major, padded)
  layouts; ``params_from_numpy`` carries JAX's float32, bf16 and quantized
  trees.
* K3/K6's padded head dims: the wrapper's route at D 24 and 192 (padded to
  32 and 256), on the CPU through the plain versions, against the plain
  forward and backward at the unpadded D: out within one bf16 ulp of each
  row's largest value, the LSE within 1e-5, dq/dk/dv within 2e-2 of their
  largest |value|.
* HF: the packer bit for bit with JAX's and the forward on it against a
  ``transformers`` ``DeepseekV2ForCausalLM`` built from a config (2e-4);
  the export equal to JAX's and reloaded by ``transformers`` with the same
  logits; ``export_hf`` writes a ``deepseek_v2`` ``config.json`` that
  ``transformers`` loads with the weights (JAX's ``export_hf`` raises on an
  MLA tree: pinned here); ``load_zoo_checkpoint`` reads ``save_pretrained``.
* The registry equals JAX's field for field; the four names resolve, and
  the port's ``zoo_model_names`` equal JAX's.
The engines, the trainer and the CLIs: ``tests/test_torch_mla_training.py``.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import mla as jmla
from llm_fp8_tpu.models import registry as jreg
from llm_fp8_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from llm_fp8_tpu.quant import recipe_set_by_name as jax_recipes
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from llm_fp8_tpu_torch.kernels import flash_attention as k3
from llm_fp8_tpu_torch.kernels import flash_attention_bwd as k6
from llm_fp8_tpu_torch.models import mla as tmla
from llm_fp8_tpu_torch.models import registry as treg
from llm_fp8_tpu_torch.models.llama import init_kv_cache
from llm_fp8_tpu_torch.quant import QTensor, quantize, recipe_set_by_name

# One torch thread per test process (see test_torch_zoo_models.py).
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2
FLIP_MARGIN = 5e-3
NAMES = ("debug-mla", "debug-mla-q")
GROUPS = ("dense_layers", "moe_layers")


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
    return (dataclasses.replace(jmla.MLA_REGISTRY[name], **kw),
            dataclasses.replace(tmla.MLA_REGISTRY[name], **kw))


@functools.lru_cache(maxsize=None)
def weights(name, dtype="float32"):
    """A numpy tree of ``name`` from JAX's init (float32), its norm weights
    drawn at random (the init has them 1), cast to ``dtype`` through JAX."""
    tree = numpy_tree(jmla.init_mla_params(jmla.MLA_REGISTRY[name],
                                           jax.random.PRNGKey(len(name)), dtype=jnp.float32))
    rng = np.random.default_rng(len(name))
    for g in GROUPS:
        for k, v in tree[g].items():
            if "norm" in k:
                tree[g][k] = (1 + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    return numpy_tree(jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(np.int32)


def _dtypes(kind):
    return (jnp.float32, torch.float32) if kind == "float32" else (jnp.bfloat16, torch.bfloat16)


def _forward(tree, toks, jcfg, tcfg, kind, **kw):
    jdt, tdt = _dtypes(kind)
    want, _, jaux = jmla.mla_forward(jax_tree(tree), jnp.asarray(toks), jcfg, compute_dtype=jdt,
                                     attn_impl="ref", return_router_aux=True, **kw)
    got, cache, taux = tmla.mla_forward(params_from_numpy(tree), torch.from_numpy(toks), tcfg,
                                        compute_dtype=tdt, return_router_aux=True)
    assert cache is None and got.dtype == torch.float32
    return np.asarray(want), got.numpy(), float(jaux), float(taux)


@pytest.mark.parametrize("name,rope", [("debug-mla", None), ("debug-mla-q", None),
                                       ("debug-mla", "yarn")])
def test_forward_float32_matches_jax(name, rope):
    kw = {} if rope is None else dict(rope_scaling=tmla._DEEPSEEK_YARN)
    jcfg, tcfg = cfgs(name, **kw)
    toks = _tokens(2, 20)
    want, got, jaux, taux = _forward(weights(name), toks, jcfg, tcfg, "float32")
    assert got.shape == (*toks.shape, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * np.abs(want).max())
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    if rope:
        base = tmla.mla_forward(params_from_numpy(weights(name)), torch.from_numpy(toks),
                                tmla.MLA_REGISTRY[name], compute_dtype=torch.float32)[0]
        # The scaling is live: it moves the logits by far more than the tolerance.
        assert (base - torch.from_numpy(got)).abs().max() > 10 * F32_TOL * np.abs(want).max()


class Routes:
    """Both sides' gate outputs, layer by layer: JAX's through a debug
    callback around its ``_deepseek_gate``, the port's around
    ``deepseek_gate``."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        real_j, real_t = jmla._deepseek_gate, tmla.deepseek_gate

        def jax_gate(h, w_router, cfg):
            out = real_j(h, w_router, cfg)
            jax.debug.callback(lambda p, i: self.jax.append((np.asarray(p), np.asarray(i))),
                               out[0], out[2], ordered=True)
            return out

        def torch_gate(h, w_router, cfg):
            out = real_t(h, w_router, cfg)
            self.torch.append((out[0].detach().float().numpy(), out[2].numpy()))
            return out

        monkeypatch.setattr(jmla, "_deepseek_gate", jax_gate)
        monkeypatch.setattr(tmla, "deepseek_gate", torch_gate)

    def first_flips(self, B, S, cfg):
        """Per sequence, the first position whose expert set differs between
        the sides in any MoE layer (S where none does); each flip must sit at
        a near-tie of JAX's probabilities: the K-th against the (K+1)-th or,
        group-limited, the chosen groups' last score against the next."""
        K = cfg.num_experts_per_tok
        first = np.full(B, S)
        assert len(self.jax) == len(self.torch) > 0
        for (pj, ij), (_, it) in zip(self.jax, self.torch):
            flip = np.array([set(a) != set(b) for a, b in zip(ij, it)])
            if not flip.any():
                continue
            srt = np.sort(pj, -1)[:, ::-1]
            margin = srt[:, K - 1] - srt[:, K]
            if cfg.topk_method == "group_limited_greedy":
                gs = np.sort(pj.reshape(len(pj), cfg.n_group, -1).max(-1), -1)[:, ::-1]
                margin = np.minimum(margin, gs[:, cfg.topk_group - 1] - gs[:, cfg.topk_group])
            assert margin[flip].max() < FLIP_MARGIN, margin[flip]
            for t in np.flatnonzero(flip):
                first[t // S] = min(first[t // S], t % S)
        return first


@pytest.mark.parametrize("name", NAMES)
def test_forward_bf16_matches_jax_before_routing_flips(name, monkeypatch):
    jcfg, tcfg = cfgs(name)
    routes = Routes(monkeypatch)
    want, got, jaux, taux = _forward(weights(name, "bfloat16"), _tokens(2, 20, seed=2), jcfg,
                                     tcfg, "bf16")
    first = routes.first_flips(2, 20, tcfg)
    assert first.sum() >= 20, first
    for b in range(2):
        np.testing.assert_allclose(got[b, :first[b]], want[b, :first[b]], rtol=0,
                                   atol=BF16_ATOL, err_msg=f"sequence {b}")
    np.testing.assert_allclose(taux, jaux, rtol=2e-2)


#: Cache dtype → (the port against JAX, the cached steps against the
#: cache-less forward), each a share of the largest |logit|.
CACHE_TOL = {"float32": (F32_TOL, F32_TOL), "bfloat16": (1e-4, 2e-2),
             "float8_e4m3fn": (1e-3, 0.25)}


@pytest.mark.parametrize("kv", list(CACHE_TOL))
@pytest.mark.parametrize("name", NAMES)
def test_latent_cache_prefill_and_decode_match_jax_and_the_full_forward(name, kv):
    """Two ragged prompts (20 and 13 tokens of a 24-token prefill) into the
    latent cache, then two decode steps of a token each, float32 compute."""
    jcfg, tcfg = cfgs(name)
    tree = weights(name)
    B, S, P = 2, 32, 24
    lens = np.asarray([20, 13], np.int32)
    toks = _tokens(B, P, seed=1)
    jp, tp = jax_tree(tree), params_from_numpy(tree)
    jc = jax_init_kv_cache(jcfg, B, S, dtype=getattr(jnp, kv))
    tc = init_kv_cache(tcfg, B, S, dtype=getattr(torch, kv), device="cpu")
    assert tuple(tc.k.shape) == jc.k.shape == (tcfg.num_layers, B, S, 1, tcfg.kv_lora_rank)
    assert tuple(tc.v.shape) == jc.v.shape == (tcfg.num_layers, B, S, 1, tcfg.qk_rope_head_dim)
    kw = dict(compute_dtype=jnp.float32)
    jl, jc = jmla.mla_forward(jp, jnp.asarray(toks), jcfg, cache=jc, start_pos=0,
                              kv_lens=jnp.asarray(lens), **kw)
    tl, tc = tmla.mla_forward(tp, torch.from_numpy(toks), tcfg, cache=tc, start_pos=0,
                              kv_lens=torch.from_numpy(lens), compute_dtype=torch.float32)
    rows_j = [np.asarray(jl)[b, :lens[b]] for b in range(B)]
    rows_t = [tl.numpy()[b, :lens[b]] for b in range(B)]
    nxt = np.asarray([[7], [11]], np.int32)
    for step in range(2):
        pos = lens + step
        jl, jc = jmla.mla_forward(jp, jnp.asarray(nxt), jcfg, cache=jc,
                                  start_pos=jnp.asarray(pos), kv_lens=jnp.asarray(pos + 1), **kw)
        tl, tc = tmla.mla_forward(tp, torch.from_numpy(nxt), tcfg, cache=tc,
                                  start_pos=torch.from_numpy(pos),
                                  kv_lens=torch.from_numpy(pos + 1), compute_dtype=torch.float32)
        rows_j.append(np.asarray(jl)[:, 0])
        rows_t.append(tl.numpy()[:, 0])
        nxt = nxt + 3
    assert torch.equal(tc.lens, torch.tensor(np.asarray(jc.lens)))
    for arena, want in ((tc.k, jc.k), (tc.v, jc.v)):
        a, w = arena.float().numpy(), np.asarray(want.astype(jnp.float32))
        if kv == "float32":  # the latents in float32: equal to its sum orders
            np.testing.assert_allclose(a, w, rtol=0, atol=1e-6 * np.abs(w).max())
        else:  # a value on a rounding boundary may store one step the other way
            assert (a == w).mean() >= 0.999, (a == w).mean()
    tol_jax, tol_full = CACHE_TOL[kv]
    top = max(np.abs(r).max() for r in rows_j)
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol_jax * top)
    _, full_cfg = cfgs(name, capacity_factor=-1.0)
    for b in range(B):
        text = np.concatenate([toks[b, :lens[b]], [7 + 3 * i + 4 * b for i in range(2)]])
        full = tmla.mla_forward(tp, torch.from_numpy(text[None].astype(np.int32)), full_cfg,
                                compute_dtype=torch.float32)[0][0]
        np.testing.assert_allclose(rows_t[b], full[:lens[b]].numpy(), rtol=0,
                                   atol=tol_full * top)
        for step in range(2):
            np.testing.assert_allclose(rows_t[B + step][b], full[lens[b] + step].numpy(),
                                       rtol=0, atol=tol_full * top)


# --------------------------------------------------------------------------
# gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_deepseek_gate_matches_jax_with_planted_ties(name):
    jcfg, tcfg = cfgs(name)
    D, E = tcfg.hidden_size, tcfg.num_experts
    rng = np.random.default_rng(5)
    h = rng.normal(size=(40, D)).astype(np.float32)
    for w in (rng.normal(0, 0.3, (D, E)).astype(np.float32), np.zeros((D, E), np.float32)):
        jp, jv, ji = jmla._deepseek_gate(jnp.asarray(h), jnp.asarray(w), jcfg)
        tp, tv, ti = tmla.deepseek_gate(torch.from_numpy(h), torch.from_numpy(w), tcfg)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    # The zero router: every probability 1/E; the lower indices (and, group-
    # limited, the lower groups) first, scaled by the routed factor.
    assert ti.tolist() == [list(range(tcfg.num_experts_per_tok))] * 40
    np.testing.assert_allclose(tv.numpy(), tcfg.routed_scaling_factor / E, rtol=1e-6)


def test_group_limited_gate_keeps_to_the_best_groups():
    """debug-mla-q: 8 experts in 2 groups, the best 1 group kept: a token
    whose two largest probabilities lie in different groups takes its
    second expert from the first one's group, as JAX."""
    jcfg, tcfg = cfgs("debug-mla-q")
    D = tcfg.hidden_size
    h = np.zeros((2, D), np.float32)
    h[:, 0] = 1.0
    w = np.zeros((D, 8), np.float32)
    w[0] = [3.0, 0.0, 0.0, 1.0, 2.9, 0.0, 0.0, 0.0]  # best: expert 0 (group 0), then 4 (group 1)
    _, tv, ti = tmla.deepseek_gate(torch.from_numpy(h), torch.from_numpy(w), tcfg)
    _, jv, ji = jmla._deepseek_gate(jnp.asarray(h), jnp.asarray(w), jcfg)
    assert ti.tolist() == [[0, 3]] * 2 == np.asarray(ji).tolist()
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


# --------------------------------------------------------------------------
# quantized trees
# --------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _mx_codes_as_jax(w, got, want):
    """MX codes against JAX's (as ``tests/test_torch_moe.py::_mx_codes_as_jax``):
    every code equals the port's exact division by the stored power of two;
    JAX's divides by XLA's CPU ``exp2`` of it, one ulp low at some
    exponents, and differs only there, by one e4m3 step (codes of one sign
    whose bits are adjacent)."""
    scale = got.spread_scale().numpy()
    exact = np.clip(w / scale, -448, 448)
    assert torch.equal(got.qvalue, quantize(torch.from_numpy(exact), got.fmt,
                                            scale=torch.ones(()), flush_subnormal=True).qvalue)
    xla = np.asarray(jnp.exp2(jnp.asarray(np.log2(scale))))
    jq = jnp.asarray(np.clip(w / xla, -448, 448)).astype(jnp.float8_e4m3fn)
    jq = np.asarray(jnp.where(jnp.abs(jq.astype(jnp.float32)) < 2.0 ** -6, 0, jq)
                    .astype(jnp.float32))
    np.testing.assert_array_equal(jq, want.float().numpy())
    differ = got.qvalue.float().numpy() != jq
    assert (xla != scale)[differ].all()
    # One e4m3 step apart: neighbouring codes of one sign.
    ours = got.qvalue.view(torch.uint8).numpy().astype(np.int32)[differ]
    theirs = torch.from_numpy(jq[differ]).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert (np.abs(ours - theirs.astype(np.int32)) == 1).all()


#: debug-mla-q's low-rank q contracts 48, which MX blocks of 32 do not
#: divide (JAX's quantize_mx refuses it): the MX case takes debug-mla.
@pytest.mark.parametrize("recipe,name", [("default", "debug-mla-q"), ("int8", "debug-mla-q"),
                                         ("mxfp8", "debug-mla")])
def test_quantize_mla_params_matches_jax_bit_for_bit(recipe, name, monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "0")
    jcfg, tcfg = cfgs(name)
    tree = weights(name)
    jq_tree = jmla.quantize_mla_params(jax_tree(tree), jax_recipes(recipe))
    jq = numpy_tree(jq_tree)
    got = tmla.quantize_mla_params(params_from_numpy(tree), recipe_set_by_name(recipe))
    carried = params_from_numpy(jq)
    quantized = set()
    for grp in GROUPS:
        for leaf, w in jq[grp].items():
            for g in (got[grp][leaf], carried[grp][leaf]):
                if isinstance(w, dict):
                    quantized.add(leaf)
                    assert isinstance(g, QTensor) and g.fmt.name == w["fmt"], leaf
                    assert (g.block_size, g.block_axis) == (w["block_size"],
                                                            w["block_axis"]), leaf
                    assert torch.equal(_bits(g.scale), _bits(tensor_from_numpy(w["scale"])))
                    if g is got[grp][leaf] and g.block_size is not None:
                        _mx_codes_as_jax(tree[grp][leaf], g, tensor_from_numpy(w["qvalue"]))
                    else:
                        assert torch.equal(_bits(g.qvalue),
                                           _bits(tensor_from_numpy(w["qvalue"]))), leaf
                else:
                    assert torch.equal(_bits(g), _bits(tensor_from_numpy(w))), leaf
    q_leaves = {"wq"} if tcfg.q_lora_rank is None else {"wq_a", "wq_b"}
    assert quantized == q_leaves | {"w_kv_a", "w_kv_b", "wo", "w_gate_up", "w_down",
                                    "w_shared_gate_up", "w_shared_down"}  # routers, norms stay
    gu = got["moe_layers"]["w_gate_up"]
    Lm, E = tcfg.num_layers - tcfg.first_k_dense_replace, tcfg.num_experts
    assert gu.qvalue.shape == (Lm, E, 128, 128)
    if recipe != "mxfp8":
        assert gu.scale.shape == (Lm, E, 1, 128)
    toks = _tokens(1, 12, seed=4)
    want, _ = jmla.mla_forward(jq_tree, jnp.asarray(toks), jcfg, compute_dtype=jnp.float32,
                               attn_impl="ref")
    out, _ = tmla.mla_forward(carried, torch.from_numpy(toks), tcfg, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_w_kv_b_dequantizes_alike_on_both_layouts(monkeypatch):
    """On the fp8native route the 2-D projections (``w_kv_b`` among them)
    hold K-major codes in padded storage, the routed experts row-major; the
    absorbed decode's ``_split_kv_b`` reads the logical ``[r, H·(dn+dv)]``
    on both layouts, equal bit for bit, and a cached prefill gives the same
    logits (to float32 sum orders: the product reads the K-major view)."""
    monkeypatch.delenv("LLM_FP8_QDOT", raising=False)
    tcfg = tmla.MLA_REGISTRY["debug-mla"]
    tree = params_from_numpy(weights("debug-mla"))
    trees = {}
    for native in ("0", "1"):
        monkeypatch.setenv("LLM_FP8_NATIVE_DOT", native)
        trees[native] = tmla.quantize_mla_params(tree, recipe_set_by_name("default"))
    xla, nat = (trees[k]["moe_layers"] for k in ("0", "1"))
    assert xla["w_kv_b"].qvalue.is_contiguous() and nat["w_kv_b"].qvalue.stride(-2) == 1
    assert nat["w_gate_up"].qvalue.is_contiguous()
    assert torch.equal(nat["w_kv_b"].qvalue, xla["w_kv_b"].qvalue)
    for li in range(1):
        a = tmla._split_kv_b(xla["w_kv_b"].layer(li), tcfg, torch.float32)
        b = tmla._split_kv_b(nat["w_kv_b"].layer(li), tcfg, torch.float32)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert a[0].shape == (4, 16, 32) and a[1].shape == (4, 32, 16)
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "0")  # one route for both trees' products
    outs = []
    for k in ("0", "1"):
        cache = init_kv_cache(tcfg, 1, 16, dtype=torch.float32, device="cpu")
        outs.append(tmla.mla_forward(trees[k], torch.tensor([[5, 9, 2]]), tcfg, cache=cache,
                                     kv_lens=torch.tensor([3]), compute_dtype=torch.float32)[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=0,
                               atol=F32_TOL * outs[0].abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_jax_mla_trees(dtype):
    tree = weights("debug-mla-q", dtype)
    got = params_from_numpy(tree)
    for grp in GROUPS:
        for k, v in tree[grp].items():
            t = got[grp][k]
            assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == v.shape, k
            assert torch.equal(_bits(t), _bits(tensor_from_numpy(v))), k
    assert torch.equal(_bits(got["lm_head"]), _bits(tensor_from_numpy(tree["lm_head"])))


# --------------------------------------------------------------------------
# K3/K6 at the padded head dims
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [24, 192])
def test_padded_head_dims_equal_the_unpadded_plain_attention(D):
    """The wrapper's route at a head dim no instance takes (zero-padded to
    32 / 256, the output and gradients sliced back) against the plain
    forward and backward at D itself: causal, ragged kv_lens, 8 q heads over
    2, the MLA scale of D."""
    assert k3.PADDED_HEAD_DIMS[D] in k3.BF16_HEAD_DIMS
    g = torch.Generator().manual_seed(D)
    B, S, Hq, Hk = 2, 48, 8, 2
    q = torch.randn(B, S, Hq, D, generator=g).bfloat16().requires_grad_(True)
    k = torch.randn(B, S, Hk, D, generator=g).bfloat16().requires_grad_(True)
    v = torch.randn(B, S, Hk, D, generator=g).bfloat16().requires_grad_(True)
    do = torch.randn(B, S, Hq, D, generator=g).bfloat16()
    kl = torch.tensor([48, 35], dtype=torch.int32)
    qo = torch.zeros(B, dtype=torch.int32)
    cfg = dict(causal=True, window=None, softcap=None, scale=D ** -0.5)
    out, lse = k3.flash_attention(q, k, v, kv_lens=kl, return_lse=True, scale=D ** -0.5)
    assert out.shape == (B, S, Hq, D)
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref, ref_lse = k3.flash_fwd_plain(q.detach(), k.detach(), v.detach(), qo, kl, **cfg)
    err = (out.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
    assert bool((err <= ulp).all()), float((err / ulp).max())
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    want = k6.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), ref, ref_lse, do,
                                        q_offset=qo, kv_lens=kl, **cfg)
    for what, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0,
                                   atol=2e-2 * b.float().abs().max().item(), err_msg=what)
    # Every other D that no instance takes still raises.
    with pytest.raises(ValueError, match="head_dim"):
        k3.flash_attention(q[..., :20], k[..., :20], v[..., :20])


# --------------------------------------------------------------------------
# registry and HF
# --------------------------------------------------------------------------

def test_registry_matches_jax_and_resolves_the_four_names():
    assert set(tmla.MLA_REGISTRY) == set(jmla.MLA_REGISTRY)
    for name, j in jmla.MLA_REGISTRY.items():
        t = tmla.MLA_REGISTRY[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert t.num_params() == j.num_params() and t.qk_head_dim == j.qk_head_dim, name
        assert t.kv_cache_dims() == j.kv_cache_dims(), name
        e = treg.resolve_model(name)
        assert e.cfg is t and e.forward_fn is tmla.mla_forward
        assert e.init_fn is tmla.init_mla_params and e.quantize_fn is tmla.quantize_mla_params
        assert treg._pack_fn_for(name) is tmla.pack_deepseek_state_dict
        assert jreg._pack_fn_for(name).__name__ == "pack_deepseek_state_dict"
    assert sorted(treg.zoo_model_names()) == sorted(jreg.zoo_model_names())
    assert not treg.UNPORTED_FAMILIES
    for name in NAMES:
        init = tmla.init_mla_params(tmla.MLA_REGISTRY[name], device="cpu", seed=0)
        want = numpy_tree(jmla.init_mla_params(jmla.MLA_REGISTRY[name], jax.random.PRNGKey(0)))
        assert set(init) == set(want)
        for grp in GROUPS:
            assert set(init[grp]) == set(want[grp]), grp
            for k, v in init[grp].items():
                assert tuple(v.shape) == want[grp][k].shape and v.dtype == torch.bfloat16, k


def _hf_model(name, seed=0, **kw):
    from transformers.models.deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM

    cfg = dataclasses.replace(tmla.MLA_REGISTRY[name], **kw)
    torch.manual_seed(seed)
    model = DeepseekV2ForCausalLM(DeepseekV2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, moe_intermediate_size=cfg.moe_intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_heads, n_routed_experts=cfg.num_experts,
        n_shared_experts=cfg.n_shared_experts, num_experts_per_tok=cfg.num_experts_per_tok,
        first_k_dense_replace=cfg.first_k_dense_replace,
        routed_scaling_factor=cfg.routed_scaling_factor, topk_method=cfg.topk_method,
        n_group=cfg.n_group, topk_group=cfg.topk_group, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
        max_position_embeddings=cfg.max_position_embeddings,
        tie_word_embeddings=cfg.tie_word_embeddings, attention_bias=False,
        attention_dropout=0.0, attn_implementation="eager"))
    with torch.no_grad():  # norms away from 1
        for n, p in model.named_parameters():
            if "norm" in n:
                p.normal_(1.0, 0.2)
    return model.eval()


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(tokens).logits.float()


@pytest.mark.parametrize("name", NAMES)
def test_packer_matches_jax_and_transformers(name):
    jcfg, tcfg = cfgs(name, capacity_factor=-1.0)  # HF never drops
    model = _hf_model(name)
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    want = numpy_tree(jmla.pack_deepseek_state_dict({k: jnp.asarray(v) for k, v in sd.items()},
                                                    jcfg, dtype=jnp.float32))
    got = treg._pack_fn_for(name)(sd, tcfg, dtype=torch.float32, device="cpu")
    assert set(got) == set(want)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for grp in GROUPS:
        assert set(got[grp]) == set(want[grp])
        for k, w in want[grp].items():
            np.testing.assert_array_equal(got[grp][k].numpy(), w, err_msg=f"{grp}/{k}")
    tokens = (torch.arange(24).reshape(2, 12) * 7) % tcfg.vocab_size
    ours, _ = tmla.mla_forward(got, tokens, tcfg, compute_dtype=torch.float32)
    torch.testing.assert_close(ours, _hf_logits(model, tokens), rtol=2e-4, atol=2e-4)
    with pytest.raises(KeyError, match="kv_b_proj"):
        treg._pack_fn_for(name)({k: v for k, v in sd.items() if "layers.1.self_attn.kv_b" not in k},
                                tcfg, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_export_reloads_in_transformers_and_export_hf_writes_deepseek_config(name, tmp_path):
    from transformers import AutoModelForCausalLM

    from llm_fp8_tpu.training.checkpoint import export_hf as jax_export_hf
    from llm_fp8_tpu_torch.training import export_hf

    jcfg, tcfg = cfgs(name, capacity_factor=-1.0)
    params = params_from_numpy(weights(name))
    sd = tmla.export_deepseek_state_dict(params, tcfg)
    jsd = jmla.export_deepseek_state_dict(jax_tree(weights(name)), jcfg)
    assert set(sd) == set(jsd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    model = _hf_model(name)
    missing, unexpected = model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                                strict=False)
    assert not unexpected and all("inv_freq" in m for m in missing)
    tokens = (torch.arange(10)[None] * 7) % tcfg.vocab_size
    ours, _ = tmla.mla_forward(params, tokens, tcfg, compute_dtype=torch.float32)
    torch.testing.assert_close(ours, _hf_logits(model, tokens), rtol=2e-4, atol=2e-4)
    export_hf(params, tcfg, str(tmp_path / "torch"))
    written = json.loads((tmp_path / "torch" / "config.json").read_text())
    assert written["model_type"] == "deepseek_v2"
    assert written["architectures"] == ["DeepseekV2ForCausalLM"]
    reloaded = AutoModelForCausalLM.from_pretrained(str(tmp_path / "torch"),
                                                    attn_implementation="eager").eval()
    torch.testing.assert_close(_hf_logits(reloaded, tokens), ours, rtol=2e-4, atol=2e-4)
    back = treg.load_zoo_checkpoint(name, str(tmp_path / "torch"), dtype=torch.float32,
                                    device="cpu")
    for grp in GROUPS:
        for k, v in params[grp].items():
            assert torch.equal(back[grp][k], v), k
    # JAX's export_hf sends an MLA tree to the Mixtral export (its config has
    # num_experts), which raises; the port tells MLA apart first.
    with pytest.raises(KeyError):
        jax_export_hf(jax_tree(weights(name)), jcfg, str(tmp_path / "jax"))


def test_load_zoo_checkpoint_reads_save_pretrained(tmp_path):
    name = "debug-mla-q"
    model = _hf_model(name, seed=1)
    model.save_pretrained(tmp_path, safe_serialization=True)
    tcfg = tmla.MLA_REGISTRY[name]
    got = treg.load_zoo_checkpoint(name, str(tmp_path), dtype=torch.float32, device="cpu")
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    want = tmla.pack_deepseek_state_dict(sd, tcfg, dtype=torch.float32, device="cpu")
    for grp in GROUPS:
        for k, v in want[grp].items():
            assert torch.equal(got[grp][k], v), k
    assert torch.equal(got["embed"], want["embed"])
