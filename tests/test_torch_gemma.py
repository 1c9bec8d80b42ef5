"""Gemma-2 in the port (``models/gemma.py``) against the JAX package's, on the
CPU.

* ``gemma_forward`` at debug-gemma2 (norm weights drawn at random, not the
  zero init) and at a narrow config with head dim 256 and a window that
  cuts the prompt, against JAX's ``gemma_forward`` (attention through its
  golden reference, ``impl="auto"`` on the CPU) on the same numpy weights
  and tokens: cache-less in float32 (within 1e-5 of the largest |logit|)
  and in bf16 (the Llama family's bf16 limit, 2e-2 absolute on logits of
  magnitude ~1: a flipped bf16 rounding of an activation moves them by up to
  ~1e-2); then a prefill of two ragged prompts into a ``KVCache`` and two
  decode steps, in float32 with a float32 cache (1e-5 of the largest |logit|,
  and equal to the cache-less forward), with a bf16 cache in bf16 compute
  (2e-2).
* The registry: ``GEMMA_REGISTRY`` equals JAX's field for field; the odd
  layer count raises; ``resolve_model``, ``zoo_model_names`` and
  ``_pack_fn_for`` take the three names; the quantize function is the Llama
  family's, and its codes and scales on a Gemma tree equal JAX's bit for
  bit; ``params_from_numpy`` carries JAX's Gemma trees (float32 and bf16,
  unquantized and quantized) leaf for leaf, bit for bit.
* ``pack_gemma2_state_dict`` against JAX's packer bit for bit, and the port's
  forward on it against ``transformers.Gemma2ForCausalLM`` built from a
  config (2e-4, the JAX test's tolerance, ``tests/test_gemma.py``).
* ``Engine(forward_fn=gemma_forward)`` against the JAX engine with its
  ``forward_fn`` (bf16 compute; bf16 and e4m3 KV): every step's logits within
  2e-2 of the largest |logit|, greedy tokens equal wherever the JAX top-2 gap
  exceeds 4x that; a Gemma tree gets no float32 head copy. ``SpecEngine``
  with a debug-gemma2 target and draft commits the plain engine's greedy
  tokens.
* One bf16-recipe ``Trainer`` step (float32 master weights, bf16 compute)
  against JAX's ``Trainer(forward_fn=gemma_forward)``: the loss within 1e-3
  relative and each gradient within 2e-2 of its largest |value| (bf16
  activations rounded at other points by XLA's fusions), with attention
  dropout 0.1 as well (the same counter hash on both sides); remat none,
  full and dots give the same loss and gradients bit for bit.
* The CLIs: ``cli.serve --model_name debug-gemma2`` serves (and drafts with
  ``--draft_model debug-gemma2``), ``--paged`` is refused with the JAX CLI's
  reason, ``cli.train --model_name debug-gemma2`` writes ``params.pkl`` with
  JAX's keys.
"""
import dataclasses
import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import gemma as jgemma
from llm_fp8_tpu.models import registry as jreg
from llm_fp8_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from llm_fp8_tpu.models.llama import quantize_params as jax_quantize_params
from llm_fp8_tpu.quant import recipe_set_by_name as jax_recipes
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu.serving import engine as jengine
from llm_fp8_tpu.training import TrainConfig as JTrainConfig
from llm_fp8_tpu.training import Trainer as JTrainer
from llm_fp8_tpu.training.quant_state import make_sinks
from llm_fp8_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from llm_fp8_tpu_torch.models import gemma as tgemma
from llm_fp8_tpu_torch.models import registry as treg
from llm_fp8_tpu_torch.models.llama import init_kv_cache, quantize_params
from llm_fp8_tpu_torch.quant import QTensor, recipe_set_by_name
from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams, SpecEngine
from llm_fp8_tpu_torch.serving import engine as tengine
from llm_fp8_tpu_torch.training import TrainConfig, Trainer
from llm_fp8_tpu_torch.training.trainer import _leaves

# One torch thread per test process (see test_torch_zoo_models.py).
torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2
NAME = "debug-gemma2"
#: A narrow Gemma-2 at head dim 256 (gemma2's), window 8 over 20-token prompts.
NARROW = dict(name="narrow-d256", vocab_size=512, hidden_size=128, intermediate_size=256,
              num_layers=2, num_heads=2, num_kv_heads=1, head_dim=256, rope_theta=10000.0,
              rms_eps=1e-6, max_position_embeddings=2048, sliding_window=8,
              query_pre_attn_scalar=256.0, tie_word_embeddings=True)
CONFIGS = {NAME: (jgemma.GEMMA_REGISTRY[NAME], tgemma.GEMMA_REGISTRY[NAME]),
           "narrow-d256": (jgemma.GemmaConfig(**NARROW), tgemma.GemmaConfig(**NARROW))}

JAX_FORWARD = jax.jit(jgemma.gemma_forward, static_argnames=("cfg", "compute_dtype"))


def numpy_tree(tree):
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def weights(name, dtype="float32"):
    """A numpy float32 tree of ``name`` from JAX's init, its norm weights
    drawn at random (the init has them 0, where ``1 + w`` hides a missed
    offset), cast to ``dtype`` through JAX."""
    jcfg = CONFIGS[name][0]
    tree = numpy_tree(jgemma.init_gemma_params(jcfg, jax.random.PRNGKey(len(name)),
                                               dtype=jnp.float32))
    rng = np.random.default_rng(len(name))
    for k, v in tree["layers"].items():
        if k.startswith("norm"):
            tree["layers"][k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    tree["final_norm"] = rng.normal(0, 0.2, tree["final_norm"].shape).astype(np.float32)
    return numpy_tree(jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(np.int32)


def _dtypes(kind):
    return (jnp.float32, torch.float32) if kind == "float32" else (jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("kind", ["float32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, kind):
    jcfg, tcfg = CONFIGS[name]
    jdt, tdt = _dtypes(kind)
    tree = weights(name)
    toks = _tokens(2, 20)
    want, _ = JAX_FORWARD(jax_tree(tree), jnp.asarray(toks), cfg=jcfg, compute_dtype=jdt)
    want = np.asarray(want)
    got = tgemma.gemma_forward(params_from_numpy(tree), torch.from_numpy(toks), tcfg,
                               compute_dtype=tdt)
    assert got.dtype == torch.float32 and got.shape == (2, 20, 512)
    top = np.abs(want).max()
    atol = F32_TOL * top if kind == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    assert np.abs(got.numpy()).max() <= jcfg.final_logit_softcap


@pytest.mark.parametrize("kind", ["float32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cache_prefill_and_decode_match_jax_and_the_full_forward(name, kind):
    """Two ragged prompts (20 and 13 tokens of a 24-token prefill) into a
    cache, then two decode steps of a third token each."""
    jcfg, tcfg = CONFIGS[name]
    jdt, tdt = _dtypes(kind)
    tree = weights(name)
    B, S, P = 2, 32, 24
    lens = np.asarray([20, 13], np.int32)
    toks = _tokens(B, P, seed=1)
    jp, tp = jax_tree(tree), params_from_numpy(tree)
    jc = jax_init_kv_cache(jcfg, B, S, dtype=jdt)
    tc = init_kv_cache(tcfg, B, S, dtype=tdt, device="cpu")
    jl, jc = JAX_FORWARD(jp, jnp.asarray(toks), cfg=jcfg, cache=jc, start_pos=0,
                         kv_lens=jnp.asarray(lens), compute_dtype=jdt)
    tl, tc = tgemma.gemma_forward(tp, torch.from_numpy(toks), tcfg, cache=tc, start_pos=0,
                                  kv_lens=torch.from_numpy(lens), compute_dtype=tdt)
    rows_j = [np.asarray(jl)[b, :lens[b]] for b in range(B)]
    rows_t = [tl.numpy()[b, :lens[b]] for b in range(B)]
    nxt = np.asarray([[7], [11]], np.int32)
    for step in range(2):
        pos = lens + step
        jl, jc = JAX_FORWARD(jp, jnp.asarray(nxt), cfg=jcfg, cache=jc,
                             start_pos=jnp.asarray(pos), kv_lens=jnp.asarray(pos + 1),
                             compute_dtype=jdt)
        tl, tc = tgemma.gemma_forward(tp, torch.from_numpy(nxt), tcfg, cache=tc,
                                      start_pos=torch.from_numpy(pos),
                                      kv_lens=torch.from_numpy(pos + 1), compute_dtype=tdt)
        rows_j.append(np.asarray(jl)[:, 0])
        rows_t.append(tl.numpy()[:, 0])
        nxt = nxt + 3
    assert torch.equal(tc.lens, torch.tensor(np.asarray(jc.lens)))
    top = max(np.abs(r).max() for r in rows_j)
    atol = F32_TOL * top if kind == "float32" else BF16_ATOL
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    if kind == "float32":
        # The cached steps equal the cache-less forward over the whole text.
        for b in range(B):
            text = np.concatenate([toks[b, :lens[b]], [7 + 3 * i + 4 * b for i in range(2)]])
            full = tgemma.gemma_forward(tp, torch.from_numpy(text[None].astype(np.int32)), tcfg,
                                        compute_dtype=torch.float32)[0]
            np.testing.assert_allclose(rows_t[b], full[:lens[b]].numpy(), rtol=0,
                                       atol=F32_TOL * top)
            for step in range(2):
                np.testing.assert_allclose(rows_t[B + step][b], full[lens[b] + step].numpy(),
                                           rtol=0, atol=F32_TOL * top)


def test_registry_matches_jax_and_resolves_the_three_names():
    assert set(tgemma.GEMMA_REGISTRY) == set(jgemma.GEMMA_REGISTRY)
    for name, j in jgemma.GEMMA_REGISTRY.items():
        assert dataclasses.asdict(tgemma.GEMMA_REGISTRY[name]) == dataclasses.asdict(j), name
        e = treg.resolve_model(name)
        assert e.cfg is tgemma.GEMMA_REGISTRY[name]
        assert e.forward_fn is tgemma.gemma_forward and e.init_fn is tgemma.init_gemma_params
        assert e.quantize_fn is quantize_params
        assert name in treg.zoo_model_names()
        assert treg._pack_fn_for(name) is tgemma.pack_gemma2_state_dict
        assert jreg._pack_fn_for(name).__name__ == "pack_gemma2_state_dict"
        assert "Gemma" not in treg.UNPORTED_FAMILIES
    with pytest.raises(ValueError, match="even num_layers"):
        dataclasses.replace(tgemma.GEMMA_REGISTRY[NAME], num_layers=3)
    assert [tgemma.layer_window(tgemma.GEMMA_REGISTRY["gemma2-9b"], i) for i in range(3)] == \
        [4096, None, 4096]
    init = tgemma.init_gemma_params(tgemma.GEMMA_REGISTRY[NAME], device="cpu", seed=0)
    want = numpy_tree(jgemma.init_gemma_params(jgemma.GEMMA_REGISTRY[NAME],
                                               jax.random.PRNGKey(0)))
    assert set(init["layers"]) == set(want["layers"]) and set(init) == set(want)
    for k, v in init["layers"].items():
        assert v.shape == want["layers"][k].shape and v.dtype == torch.bfloat16, k
        if k.startswith("norm"):
            assert not v.any(), k  # zero-initialised, applied as 1 + w


def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_params_from_numpy_carry_jax_gemma_trees(dtype):
    tree = weights(NAME, dtype)
    jq_tree = jax_quantize_params(jax_tree(tree), jax_recipes("default"))
    jq = numpy_tree(jq_tree)
    got_q = quantize_params(params_from_numpy(tree), recipe_set_by_name("default"))
    carried = params_from_numpy(jq)
    n_q = 0
    for leaf, w in jq["layers"].items():
        if isinstance(w, dict):
            n_q += 1
            for g in (got_q["layers"][leaf], carried["layers"][leaf]):
                assert isinstance(g, QTensor) and g.fmt.name == w["fmt"]
                assert torch.equal(_bits(g.qvalue), _bits(tensor_from_numpy(w["qvalue"]))), leaf
                assert torch.equal(_bits(g.scale), _bits(tensor_from_numpy(w["scale"]))), leaf
        else:
            for g in (got_q["layers"][leaf], carried["layers"][leaf]):
                assert torch.equal(_bits(g), _bits(tensor_from_numpy(w))), leaf
    assert n_q == 4  # wqkv, wo, w_gate_up, w_down; the norms and the embedding stay
    assert torch.equal(_bits(carried["embed"]), _bits(tensor_from_numpy(tree["embed"])))
    # The quantized tree's logits, both packages on the same codes.
    toks = _tokens(1, 12, seed=4)
    want, _ = JAX_FORWARD(jq_tree, jnp.asarray(toks), cfg=CONFIGS[NAME][0],
                          compute_dtype=jnp.float32)
    got = tgemma.gemma_forward(carried, torch.from_numpy(toks), CONFIGS[NAME][1],
                               compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def _hf_gemma2(cfg, seed=0):
    from transformers import Gemma2Config, Gemma2ForCausalLM

    torch.manual_seed(seed)
    model = Gemma2ForCausalLM(Gemma2Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps,
        max_position_embeddings=cfg.max_position_embeddings,
        tie_word_embeddings=cfg.tie_word_embeddings, sliding_window=cfg.sliding_window,
        query_pre_attn_scalar=cfg.query_pre_attn_scalar,
        attn_logit_softcapping=cfg.attn_logit_softcap,
        final_logit_softcapping=cfg.final_logit_softcap,
        hidden_activation="gelu_pytorch_tanh", attention_dropout=0.0,
        attn_implementation="eager"))
    with torch.no_grad():  # norms away from their zero init
        for n, p in model.named_parameters():
            if "norm" in n:
                p.normal_(0.0, 0.2)
    return model.eval()


def test_packer_matches_jax_and_transformers():
    jcfg, tcfg = CONFIGS[NAME]
    model = _hf_gemma2(tcfg)
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    want = numpy_tree(jgemma.pack_gemma2_state_dict({k: jnp.asarray(v) for k, v in sd.items()},
                                                    jcfg, dtype=jnp.float32))
    got = tgemma.pack_gemma2_state_dict(sd, tcfg, dtype=torch.float32, device="cpu")
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    np.testing.assert_array_equal(got["embed"].numpy(), want["embed"])
    np.testing.assert_array_equal(got["final_norm"].numpy(), want["final_norm"])
    for k, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), w, err_msg=k)
    # 16 tokens over layer 0's window of 6: the window masks.
    tokens = (torch.arange(16)[None] * 7) % tcfg.vocab_size
    with torch.no_grad():
        hf = model(tokens).logits.float()
    ours = tgemma.gemma_forward(got, tokens, tcfg, compute_dtype=torch.float32)
    torch.testing.assert_close(ours, hf, rtol=2e-4, atol=2e-4)
    with pytest.raises(KeyError, match="model.norm.weight"):
        tgemma.pack_gemma2_state_dict({k: v for k, v in sd.items() if k != "model.norm.weight"},
                                      tcfg, device="cpu")


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

PROMPT_LENS = (5, 12, 20)
MAX_NEW = 6


class JaxRecorder(jengine.Engine):
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


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 512, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(cls, mod, params, cfg, kv, **kw):
    eng = cls(params, cfg, mod.EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,),
                                            kv_dtype=kv, decode_burst=1), **kw)
    eng.rows = []
    reqs = [eng.add_request(p, mod.SamplingParams(max_new_tokens=MAX_NEW)) for p in _prompts()]
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_engine_matches_jax_engine(kv):
    jcfg, tcfg = CONFIGS[NAME]
    tree = weights(NAME, "bfloat16")
    jeng, jreqs = _serve(JaxRecorder, jengine, jax_tree(tree), jcfg, kv,
                         forward_fn=jgemma.gemma_forward)
    teng, treqs = _serve(TorchRecorder, tengine, params_from_numpy(tree), tcfg, kv,
                         forward_fn=tgemma.gemma_forward, device="cpu")
    assert not teng._fp8_arena and teng.cache.k.dtype == (
        torch.bfloat16 if kv == "bf16" else torch.float8_e4m3fn)
    assert "head_f32" not in teng.params  # bf16 compute: no float32 head copy
    held = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.output) == MAX_NEW
        jrows, trows = jeng.rows[jr.request_id], teng.rows[tr.request_id]
        top = max(np.abs(r).max() for r in jrows)
        for step, (jrow, trow) in enumerate(zip(jrows, trows)):
            np.testing.assert_allclose(trow, jrow, rtol=0, atol=BF16_ATOL * top,
                                       err_msg=f"request {jr.request_id} step {step}")
            gap = np.diff(np.sort(jrow)[-2:])[0]
            if gap > 4 * BF16_ATOL * top:
                held += 1
                assert tr.output[step] == jr.output[step], (jr.request_id, step)
            elif tr.output[step] != jr.output[step]:
                break  # a near-tie went the other way: the texts part here
    assert held > 0


def test_spec_engine_gives_the_plain_engines_greedy_tokens():
    _, tcfg = CONFIGS[NAME]
    target = params_from_numpy(weights(NAME, "bfloat16"))
    draft = tgemma.init_gemma_params(tcfg, device="cpu", seed=3)
    ecfg = EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,), kv_dtype="bf16")
    want = []
    eng = Engine(target, tcfg, ecfg, device="cpu", forward_fn=tgemma.gemma_forward)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8)) for p in _prompts()]
    eng.run()
    want = [r.output for r in reqs]
    spec = SpecEngine(target, tcfg, draft, tcfg, ecfg, gamma=3, device="cpu",
                      forward_fn=tgemma.gemma_forward, draft_forward_fn=tgemma.gemma_forward)
    reqs = [spec.add_request(p, SamplingParams(max_new_tokens=8)) for p in _prompts()]
    spec.run()
    assert [r.output for r in reqs] == want
    assert "head_f32" not in spec.dparams and spec.rounds_total > 0
    # The target drafting for itself accepts every proposal.
    spec = SpecEngine(target, tcfg, target, tcfg, ecfg, gamma=3, device="cpu",
                      forward_fn=tgemma.gemma_forward, draft_forward_fn=tgemma.gemma_forward)
    reqs = [spec.add_request(p, SamplingParams(max_new_tokens=8)) for p in _prompts()]
    spec.run()
    assert [r.output for r in reqs] == want


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _batch(seed, B=2, S=24):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.int32)
    mask[:, -3:] = 0
    return {"input_ids": rng.randint(0, 512, (B, S)).astype(np.int32), "attention_mask": mask}


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_trainer_step_matches_jax(rate):
    """The step's loss and every parameter's gradient: JAX's from the
    value_and_grad of its Trainer's own ``_forward_loss`` (what its step
    differentiates), the port's from ``Trainer.loss_and_grads``; then one
    ``train_step`` on each side, the losses and the tokens counted."""
    jcfg, tcfg = CONFIGS[NAME]
    tree = weights(NAME)
    kw = dict(recipes="bf16", warmup_steps=0, total_steps=10, learning_rate=1e-3,
              attention_dropout=rate)
    b = _batch(int(rate > 0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jt = JTrainer(jcfg, JTrainConfig(**kw), forward_fn=jgemma.gemma_forward)
    js = jt.init_state(jax_tree(tree))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jt._forward_loss, has_aux=True))(
        js.params, make_sinks(jcfg), jb, js.qstate, js.step)
    pt = Trainer(tcfg, TrainConfig(**kw), device="cpu", forward_fn=tgemma.gemma_forward)
    ps = pt.init_state(params_from_numpy(tree))
    loss, n, _, stats, grads, _ = pt.loss_and_grads(ps, b)
    assert np.isnan(float(stats[0]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    want = dict(_leaves(numpy_tree(jgrads)))
    assert sorted(want) == sorted(grads)
    for path, g in grads.items():
        w = want[path]
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(), err_msg=path)
    js, jm = jt.train_step(js, jb)
    ps, pm = pt.train_step(ps, b)
    assert int(pm["finite"]) == int(jm["finite"]) == 1
    assert int(pm["tokens"]) == int(jm["tokens"]) == int(n)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-3)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_modes_are_bit_for_bit(rate):
    _, tcfg = CONFIGS[NAME]
    params = params_from_numpy(weights(NAME))
    tokens = torch.from_numpy(_batch(3)["input_ids"]).long()
    leaves = [t for _, t in _leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    runs = {}
    for remat in ("none", "full", "dots"):
        logits = tgemma.gemma_forward(params, tokens, tcfg, remat=remat, dropout_p=rate,
                                      dropout_seed=9)
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 512),
                                                 tokens[:, 1:].reshape(-1))
        runs[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], runs["none"][1])), remat


# --------------------------------------------------------------------------
# CLIs
# --------------------------------------------------------------------------

SERVE_ARGS = ["--random_init", "--device", "cpu", "--num_requests", "2", "--prompt_len", "10",
              "--max_new_tokens", "4", "--max_seq_len", "64", "--max_slots", "2"]


def test_serve_cli_serves_and_drafts_gemma_and_refuses_paged(capsys):
    from llm_fp8_tpu_torch.cli.serve import main

    done = main(["--model_name", NAME, "--precision", "fp8", "--kv_dtype", "fp8"] + SERVE_ARGS)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 2 and out["generated_tokens"] == 8
    assert out["kv_dtype"] == "float8_e4m3fn" and all(len(r.output) == 4 for r in done)
    main(["--model_name", NAME, "--draft_model", NAME, "--gamma", "3"] + SERVE_ARGS)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["generated_tokens"] == 8 and out["spec_gamma"] == 3
    with pytest.raises(SystemExit, match="Llama-family paged decode path"):
        main(["--model_name", NAME, "--paged"] + SERVE_ARGS)


def test_train_cli_writes_the_jax_params_pickle(tmp_path):
    from llm_fp8_tpu_torch.cli.train import main

    report = main(["--model_name", NAME, "--random_init", "--synthetic_samples", "16",
                   "--mixed_precision", "bf16", "--device", "cpu", "--batch_size", "4",
                   "--max_seq_length", "24", "--num_epochs", "1", "--num_warmup_steps", "1",
                   "--remat", "dots", "--log_dir", str(tmp_path / "runs"),
                   "--output_dir", str(tmp_path / "out")])
    assert report["non_finite_steps"] == 0 and report["steps"] >= 2
    with open(tmp_path / "out" / "params.pkl", "rb") as f:
        got = pickle.load(f)
    want = numpy_tree(jgemma.init_gemma_params(jgemma.GEMMA_REGISTRY[NAME],
                                               jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32, path
