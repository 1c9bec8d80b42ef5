"""The GPT-2 and NeoX families of the port against the JAX package, on the CPU.

* ``layernorm`` against JAX's: equal within one float32 rounding (2e-6
  relative), in float32 and in bf16 (one bf16 ulp).
* ``gpt2_forward`` / ``neox_forward`` for all 8 debug configs against JAX's
  (attention through ``attn_impl="ref"``, the plain golden) on the same numpy
  weights (random biases and norms too) and tokens: cache-less, then a
  prefill of two ragged prompts into a ``KVCache`` and two decode steps,
  with a bf16 and an e4m3 cache. Both compute in float32, so the cache-less
  logits agree to float32 sum orders: 2e-5 of the largest |logit|
  (readings: about 1e-6). A cache stores K/V rounded to its dtype, and
  where the two float32 inputs straddle a rounding boundary one stored value
  lands a whole step (2^-8 of it in bf16, 2^-3 in e4m3) the other way: the
  bf16 cache is held to 2e-4 and the e4m3 cache to 1e-3 of the largest
  |logit| (readings: up to 3.3e-5 with bf16).
* The registries equal JAX's, field by field, and the properties.
* The 7 packers against JAX's on the same state dict, bit for bit, and the
  port's forward on them against ``transformers`` models built from a config
  in the test (GPT-2, OPT, GPTBigCode, GPT-NeoX twice, Falcon, GPT-J; BTLM
  has no ``transformers`` class), as the JAX package's own parity tests hold
  them (2e-4).
* ``quantize_zoo_params`` codes and scales bit for bit with JAX's for the
  default (LAYERWISE), int8 and mxfp8 recipe sets; ``params_from_numpy``
  carries every debug config's quantized tree, QTensor leaves included.
* The fp8native layout pads K and N to multiples of 16 once; the padded
  product equals the unpadded one bit for bit.
* The float32 copy of a tied head gives ``x @ head.float().T`` bit for bit.
* The MoE and MLA names resolve to the port's entries, named as JAX's
  (ported: ``tests/test_torch_moe.py``, ``tests/test_torch_mla.py``; Gemma:
  ``tests/test_torch_gemma.py``); an unknown name raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import gpt2 as jgpt2
from llm_fp8_tpu.models import neox as jneox
from llm_fp8_tpu.models import registry as jreg
from llm_fp8_tpu.models.llama import init_kv_cache as jax_init_kv_cache
from llm_fp8_tpu.ops.layernorm import layernorm as jax_layernorm
from llm_fp8_tpu.quant import recipe_set_by_name as jax_recipes
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu_torch.convert import params_from_numpy, tensor_from_numpy
from llm_fp8_tpu_torch.models import gpt2 as tgpt2
from llm_fp8_tpu_torch.models import neox as tneox
from llm_fp8_tpu_torch.models import registry as treg
from llm_fp8_tpu_torch.models import zoo
from llm_fp8_tpu_torch.models.llama import init_kv_cache
from llm_fp8_tpu_torch.ops.layernorm import layernorm
from llm_fp8_tpu_torch.quant import QTensor, recipe_set_by_name
from llm_fp8_tpu_torch.quant.dot import padded_operands

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

DEBUG = ["debug-gpt2", "debug-opt", "debug-bigcode", "debug-btlm", "debug-neox",
         "debug-falcon", "debug-neox-seq", "debug-gptj"]
FAMILIES = {name: (jgpt2, tgpt2, "gpt2") if name in jgpt2.GPT2_REGISTRY
            else (jneox, tneox, "neox") for name in DEBUG}


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
def weights(name):
    """The JAX config and a numpy param tree of ``name``: JAX's init, with
    every norm and bias drawn at random too (init has them 1 and 0)."""
    jmod, _, fam = FAMILIES[name]
    cfg = getattr(jmod, "GPT2_REGISTRY" if fam == "gpt2" else "NEOX_REGISTRY")[name]
    init = jgpt2.init_gpt2_params if fam == "gpt2" else jneox.init_neox_params
    tree = numpy_tree(init(cfg, jax.random.PRNGKey(len(name))))
    rng = np.random.default_rng(len(name))

    def perturb(path, a):
        leaf = path.split("/")[-1]
        if leaf.startswith(("ln", "b_", "lm_head_b")):
            return (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        return a

    def walk(t, path=""):
        return ({k: walk(v, f"{path}/{k}") for k, v in t.items()} if isinstance(t, dict)
                else perturb(path, t))

    return cfg, walk(tree)


#: The JAX forwards, jitted once: eagerly, JAX traces and compiles the layer
#: scan again at every call (about 4 s a prefill on the CPU).
JAX_FORWARDS = {fam: jax.jit(fn, static_argnames=("cfg", "attn_impl"))
                for fam, fn in (("gpt2", jgpt2.gpt2_forward), ("neox", jneox.neox_forward))}


def forwards(name):
    """``(jax_forward(params, tokens, cfg, ...), torch_forward, torch_cfg)``."""
    _, _, fam = FAMILIES[name]
    jitted = JAX_FORWARDS[fam]
    tf = tgpt2.gpt2_forward if fam == "gpt2" else tneox.neox_forward
    treg_ = tgpt2.GPT2_REGISTRY if fam == "gpt2" else tneox.NEOX_REGISTRY
    return (lambda p, t, cfg, **kw: jitted(p, t, cfg=cfg, **kw)), tf, treg_[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) * 3 for s in ((5, 7, 96), (96,), (96,)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_layernorm(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b),
                                    1e-5).astype(jnp.float32))
    got = layernorm(torch.from_numpy(x).to(dtype), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", DEBUG)
def test_forward_matches_jax(name):
    jcfg, tree = weights(name)
    jf, tf, tcfg = forwards(name)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jf(jax_tree(tree), jnp.asarray(tokens), jcfg, attn_impl="ref"))
    got = tf(params_from_numpy(tree), torch.from_numpy(tokens), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


#: cache dtype → (JAX dtype, the logits' tolerance as a share of the largest |logit|)
CACHES = {"bf16": (torch.bfloat16, jnp.bfloat16, 2e-4),
          "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn, 1e-3)}


@pytest.mark.parametrize("kv", list(CACHES))
@pytest.mark.parametrize("name", DEBUG)
def test_cache_prefill_and_decode_match_jax(name, kv):
    tdt, jdt, tol = CACHES[kv]
    jcfg, tree = weights(name)
    jf, tf, tcfg = forwards(name)
    B, bucket, S_max, lens = 2, 16, 32, np.asarray([16, 11], np.int32)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, bucket)).astype(np.int32)
    jp, tp = jax_tree(tree), params_from_numpy(tree)
    jcache = jax_init_kv_cache(jcfg, B, S_max, dtype=jdt)
    tcache = init_kv_cache(tcfg, B, S_max, dtype=tdt, device="cpu")
    want, jcache = jf(jp, jnp.asarray(tokens), jcfg, cache=jcache, start_pos=0,
                      kv_lens=jnp.asarray(lens), attn_impl="ref")
    got, tcache = tf(tp, torch.from_numpy(tokens), tcfg, cache=tcache, start_pos=0,
                     kv_lens=torch.from_numpy(lens))
    want = np.asarray(want)
    rows = [(got[b, :n].numpy(), want[b, :n]) for b, n in enumerate(lens)]
    last, pos = want[np.arange(B), lens - 1], lens.copy()
    for _ in range(2):
        tok = np.argmax(last, axis=-1).astype(np.int32)[:, None]
        want, jcache = jf(jp, jnp.asarray(tok), jcfg, cache=jcache, start_pos=jnp.asarray(pos),
                          kv_lens=jnp.asarray(pos + 1), attn_impl="ref")
        got, tcache = tf(tp, torch.from_numpy(tok), tcfg, cache=tcache,
                         start_pos=torch.from_numpy(pos), kv_lens=torch.from_numpy(pos + 1))
        last = np.asarray(want)[:, 0]
        rows.append((got[:, 0].numpy(), last))
        pos = pos + 1
    np.testing.assert_array_equal(tcache.lens.numpy(), np.asarray(jcache.lens))
    top = max(np.abs(w).max() for _, w in rows)
    for step, (g, w) in enumerate(rows):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * top, err_msg=f"row {step}")


@pytest.mark.parametrize("family", ["GPT2_REGISTRY", "NEOX_REGISTRY"])
def test_registries_equal_jax_field_by_field(family):
    jr = getattr(jgpt2 if family == "GPT2_REGISTRY" else jneox, family)
    tr = getattr(tgpt2 if family == "GPT2_REGISTRY" else tneox, family)
    assert list(tr) == list(jr)
    props = ("head_dim", "kv_dim", "intermediate_size") if family == "GPT2_REGISTRY" \
        else ("head_dim", "rotary_dim", "attn_has_bias")
    for name in jr:
        assert dataclasses.asdict(tr[name]) == dataclasses.asdict(jr[name]), name
        for p in props:
            assert getattr(tr[name], p) == getattr(jr[name], p), (name, p)


# --------------------------------------------------------------------------
# packers
# --------------------------------------------------------------------------


def _hf_model(kind, cfg):
    """A ``transformers`` model of ``cfg``'s shape, random weights (no download)."""
    import transformers as T

    torch.manual_seed(len(kind))
    common = dict(vocab_size=cfg.vocab_size)
    if kind == "gpt2":
        return T.GPT2LMHeadModel(T.GPT2Config(
            **common, n_positions=cfg.max_position_embeddings, n_embd=cfg.hidden_size,
            n_layer=cfg.num_layers, n_head=cfg.num_heads, resid_pdrop=0.0, embd_pdrop=0.0,
            attn_pdrop=0.0, layer_norm_epsilon=cfg.ln_eps))
    if kind == "opt":
        return T.OPTForCausalLM(T.OPTConfig(
            **common, hidden_size=cfg.hidden_size, ffn_dim=cfg.intermediate_size,
            num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
            max_position_embeddings=cfg.max_position_embeddings, activation_function="relu",
            do_layer_norm_before=True, word_embed_proj_dim=cfg.hidden_size, dropout=0.0,
            attention_dropout=0.0, layerdrop=0.0))
    if kind == "bigcode":
        return T.GPTBigCodeForCausalLM(T.GPTBigCodeConfig(
            **common, n_positions=cfg.max_position_embeddings, n_embd=cfg.hidden_size,
            n_layer=cfg.num_layers, n_head=cfg.num_heads, multi_query=True,
            activation_function="gelu_pytorch_tanh", resid_pdrop=0.0, embd_pdrop=0.0,
            attn_pdrop=0.0, layer_norm_epsilon=cfg.ln_eps))
    if kind == "neox":
        return T.GPTNeoXForCausalLM(T.GPTNeoXConfig(
            **common, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
            rotary_pct=cfg.rotary_pct, rotary_emb_base=cfg.rotary_base,
            use_parallel_residual=cfg.parallel_residual, layer_norm_eps=cfg.ln_eps,
            hidden_act="gelu", max_position_embeddings=64, attention_dropout=0.0,
            hidden_dropout=0.0, tie_word_embeddings=False))
    if kind == "falcon":
        return T.FalconForCausalLM(T.FalconConfig(
            **common, hidden_size=cfg.hidden_size, ffn_hidden_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
            multi_query=True, parallel_attn=True, new_decoder_architecture=False, alibi=False,
            bias=False, layer_norm_epsilon=cfg.ln_eps, rope_theta=cfg.rotary_base,
            attention_dropout=0.0, hidden_dropout=0.0))
    assert kind == "gptj"
    return T.GPTJForCausalLM(T.GPTJConfig(
        **common, n_embd=cfg.hidden_size, n_inner=cfg.intermediate_size, n_layer=cfg.num_layers,
        n_head=cfg.num_heads, rotary_dim=cfg.rotary_dim, n_positions=64,
        layer_norm_epsilon=cfg.ln_eps, activation_function="gelu_new", attn_pdrop=0.0,
        embd_pdrop=0.0, resid_pdrop=0.0, tie_word_embeddings=False))


def _btlm_state_dict(cfg):
    """A BTLM-layout state dict (``transformers`` has no BTLM class)."""
    rng = np.random.default_rng(5)
    D, I = cfg.hidden_size, cfg.intermediate_size

    def r(*s):
        return (rng.standard_normal(s) * 0.05).astype(np.float32)

    sd = {"transformer.wte.weight": r(cfg.vocab_size, D), "transformer.ln_f.weight": 1 + r(D),
          "transformer.ln_f.bias": r(D)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": 1 + r(D), p + "ln_1.bias": r(D),
                   p + "ln_2.weight": 1 + r(D), p + "ln_2.bias": r(D),
                   p + "attn.c_attn.weight": r(D, 3 * D), p + "attn.c_attn.bias": r(3 * D),
                   p + "attn.c_proj.weight": r(D, D), p + "attn.c_proj.bias": r(D),
                   p + "mlp.c_fc.weight": r(D, I), p + "mlp.c_fc.bias": r(I),
                   p + "mlp.c_fc2.weight": r(D, I), p + "mlp.c_fc2.bias": r(I),
                   p + "mlp.c_proj.weight": r(I, D), p + "mlp.c_proj.bias": r(D)})
    return sd


#: packer → (the debug config it packs, the transformers model kind or None)
PACKERS = {"pack_gpt2_state_dict": ("debug-gpt2", "gpt2"),
           "pack_opt_state_dict": ("debug-opt", "opt"),
           "pack_bigcode_state_dict": ("debug-bigcode", "bigcode"),
           "pack_btlm_state_dict": ("debug-btlm", None),
           "pack_neox_state_dict": ("debug-neox", "neox"),
           "pack_falcon_state_dict": ("debug-falcon", "falcon"),
           "pack_gptj_state_dict": ("debug-gptj", "gptj")}


@functools.lru_cache(maxsize=None)
def _state_dict(packer):
    name, kind = PACKERS[packer]
    jcfg = forwards(name)[2]
    if kind is None:
        return None, _btlm_state_dict(jcfg)
    model = _hf_model(kind, jcfg).eval()
    return model, {k: v.float().numpy() for k, v in model.state_dict().items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("packer", list(PACKERS))
def test_packers_match_jax_bit_for_bit(packer):
    name = PACKERS[packer][0]
    _, sd = _state_dict(packer)
    jmod, tmod, _ = FAMILIES[name]
    jcfg, tcfg = weights(name)[0], forwards(name)[2]
    want = _flat(numpy_tree(getattr(jmod, packer)({k: jnp.asarray(v) for k, v in sd.items()},
                                                  jcfg)))
    got = _flat(getattr(tmod, packer)(sd, tcfg, device="cpu"))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)


HF_PACKERS = [p for p, (_, kind) in PACKERS.items() if kind is not None] + ["neox-seq"]


@pytest.mark.parametrize("packer", HF_PACKERS)
def test_forward_on_packed_weights_matches_transformers(packer):
    if packer == "neox-seq":  # the sequential-residual NeoX block
        name, tcfg = "debug-neox-seq", tneox.NEOX_REGISTRY["debug-neox-seq"]
        model = _hf_model("neox", tcfg).eval()
        sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
        packer = "pack_neox_state_dict"
    else:
        name = PACKERS[packer][0]
        model, sd = _state_dict(packer)
        tcfg = forwards(name)[2]
    tmod = FAMILIES[name][1]
    params = getattr(tmod, packer)(sd, tcfg, device="cpu")
    tokens = torch.arange(24).reshape(2, 12) % tcfg.vocab_size
    with torch.no_grad():
        want = model(tokens).logits.float()
    fwd = tgpt2.gpt2_forward if tmod is tgpt2 else tneox.neox_forward
    got = fwd(params, tokens, tcfg)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# quantization, conversion, layout
# --------------------------------------------------------------------------


QUANT_CASES = [("default", "debug-btlm"), ("int8", "debug-btlm"), ("default", "debug-falcon"),
               ("int8", "debug-gptj"), ("mxfp8", "debug-falcon"), ("mxfp8", "debug-gpt2")]


def _bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


@pytest.mark.parametrize("recipes,name", QUANT_CASES)
def test_quantize_zoo_params_matches_jax_bit_for_bit(recipes, name):
    """Codes and scales bit for bit. One exception, on the JAX side: its MX
    scale is ``exp2(shared_exp)``, and XLA's exp2 on the CPU misses some
    integer powers of two by an ulp (2^-13 among them), so its codes divide
    by a scale one float32 ulp off the one it stores; where ``x / scale``
    lies within 2^-20 of the midpoint of two e4m3 codes, JAX's code is the
    other neighbour. The port's is the correctly rounded one there."""
    jcfg, tree = weights(name)
    want = numpy_tree(jreg.quantize_zoo_params(jax_tree(tree), jax_recipes(recipes)))
    got = treg.quantize_zoo_params(params_from_numpy(tree), recipe_set_by_name(recipes))
    near_ties = 0
    for leaf, w in want["layers"].items():
        g = got["layers"][leaf]
        if not isinstance(w, dict):
            np.testing.assert_array_equal(g.numpy(), w)
            continue
        assert isinstance(g, QTensor) and g.fmt.name == w["fmt"]
        assert (g.block_size, g.block_axis) == (w["block_size"], w["block_axis"])
        assert torch.equal(_bits(g.scale), _bits(tensor_from_numpy(w["scale"]))), leaf
        wq = tensor_from_numpy(w["qvalue"])
        differ = _bits(g.qvalue) != _bits(wq)
        if differ.any():
            assert g.block_size is not None, (leaf, "codes differ off the MX route")
            r = torch.tensor(tree["layers"][leaf]) / g.spread_scale()
            a, b = g.qvalue.float()[differ], wq.float()[differ]
            mid = (a + b) / 2
            assert ((r[differ] - mid).abs() <= 2.0 ** -20 * mid.abs()).all(), leaf
            assert torch.equal(a, r[differ].to(g.qvalue.dtype).float())  # correctly rounded
            near_ties += int(differ.sum())
    assert near_ties <= 4


@pytest.mark.parametrize("name", DEBUG)
def test_params_from_numpy_carries_the_zoo_trees(name):
    """JAX zoo trees are plain dicts of stacked arrays (QTensor leaves after
    quantization): carried leaf for leaf, bit for bit."""
    jcfg, tree = weights(name)
    jq = numpy_tree(jreg.quantize_zoo_params(jax_tree(tree), jax_recipes("default")))
    got = _flat(params_from_numpy(jq))
    want = _flat({k: v for k, v in jq.items()})
    n_q = 0
    for path, t in got.items():
        if isinstance(t, QTensor):
            n_q += 1
            w = want[path + "/qvalue"] if path + "/qvalue" in want else None
            assert w is not None
            np.testing.assert_array_equal(t.qvalue.view(torch.uint8).numpy(),
                                          np.asarray(w).view(np.uint8))
            np.testing.assert_array_equal(t.scale.numpy(), want[path + "/scale"])
        else:
            np.testing.assert_array_equal(t.numpy(), want[path])
    assert n_q == 4  # w_qkv, w_out, w_fc, w_proj


def test_fp8native_layout_pads_once_and_the_padded_product_is_exact(monkeypatch):
    """debug-btlm's MLP (340 wide, fc 680) on the fp8native route: the codes
    are a K-major view into zero-padded [Np, Kp] storage (made once, by
    ``quantize_zoo_params``), and the product through ``padded_operands``
    equals the unpadded float32 product bit for bit. The activation codes
    are small integers, so every partial sum is exact in float32 in any
    order."""
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "1")
    _, tree = weights("debug-btlm")
    q = treg.quantize_zoo_params(params_from_numpy(tree), recipe_set_by_name("default"))
    for leaf, (K, N) in {"w_fc": (128, 680), "w_proj": (340, 128)}.items():
        w = q["layers"][leaf]
        assert tuple(w.qvalue.shape) == (2, K, N) and w.qvalue.stride(-2) == 1
        ld = -(-K // 16) * 16
        assert w.qvalue.stride(-1) == ld
        assert w.qvalue.untyped_storage().nbytes() == 2 * (-(-N // 16) * 16) * ld
        one = w.layer(1)
        a = torch.randint(-8, 9, (7, K), generator=torch.Generator().manual_seed(K)).float()
        a = a.to(torch.float8_e4m3fn)
        ap, bp = padded_operands(a, one.qvalue)
        assert ap.shape[1] % 16 == 0 and bp.shape[1] % 16 == 0
        assert not ap[:, K:].float().any() and not bp[K:].float().any() \
            and not bp[:, N:].float().any()
        ints = a.float() @ one.qvalue.float()
        assert torch.equal((ap.float() @ bp.float())[:, :N], ints)
        # A layout quantize_zoo_params did not pad is refused, not padded per call.
        with pytest.raises(ValueError, match="serving_layout"):
            padded_operands(a, one.qvalue.contiguous())


def test_float32_head_copy_gives_the_same_logits_bit_for_bit():
    _, tree = weights("debug-falcon")
    params = params_from_numpy(tree)
    params["wte"] = params["wte"].to(torch.bfloat16)
    served = zoo.with_f32_head(params)
    assert served[zoo.HEAD_F32].dtype == torch.float32 and zoo.with_f32_head(served) is served
    assert torch.equal(served[zoo.HEAD_F32], params["wte"].float())
    x = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(0))
    want = x @ params["wte"].float().T
    assert torch.equal(zoo.lm_logits(served, x), want)
    assert torch.equal(zoo.lm_logits(params, x), want)


@pytest.mark.parametrize("name,family", [("qwen3-30b-a3b", "MoE"), ("mixtral-8x7b", "MoE"),
                                         ("deepseek-v2-lite", "MLA")])
def test_resolve_model_refuses_unported_families(name, family):
    assert name in jreg.zoo_model_names()
    if family not in treg.UNPORTED_FAMILIES:  # MoE and MLA: ported, resolved like JAX
        assert treg.resolve_model(name).cfg.name == jreg.resolve_model(name).cfg.name
        assert name in treg.zoo_model_names()
    else:
        with pytest.raises(NotImplementedError, match=f"{family} family is not ported"):
            treg.resolve_model(name)
    with pytest.raises(ValueError, match="unknown model"):
        treg.resolve_model("no-such-model")


def test_resolve_model_maps_every_ported_name_like_jax():
    names = treg.zoo_model_names()
    assert set(names) <= set(jreg.zoo_model_names())
    for name in names:
        t, j = treg.resolve_model(name), jreg.resolve_model(name)
        assert t.forward_fn.__name__ == j.forward_fn.__name__, name
        assert t.init_fn.__name__ == j.init_fn.__name__, name
    for name in DEBUG[:-1]:
        if name != "debug-bigcode":  # JAX's prefix table names no debug-bigcode packer
            assert treg._pack_fn_for(name).__name__ == jreg._pack_fn_for(name).__name__


def test_rotary_tables_and_slopes_are_built_once_per_device(monkeypatch):
    """A captured decode step may read no host tensor: the rotary inverse
    frequencies and the ALiBi slopes are made once and then only read."""
    tneox._inv_freq.cache_clear()
    calls = []
    real = tneox.rope_frequencies
    monkeypatch.setattr(tneox, "rope_frequencies", lambda *a: (calls.append(a), real(*a))[1])
    _, tree = weights("debug-gptj")
    params, cfg = params_from_numpy(tree), tneox.NEOX_REGISTRY["debug-gptj"]
    cache = init_kv_cache(cfg, 1, 16, device="cpu")
    for start in range(3):
        tneox.neox_forward(params, torch.tensor([[5]]), cfg, cache=cache,
                           start_pos=torch.tensor([start]), kv_lens=torch.tensor([start + 1]))
    assert calls == [(cfg.rotary_dim, cfg.rotary_base)]
    from llm_fp8_tpu_torch.ops.attention import default_alibi_slopes

    assert default_alibi_slopes(4, torch.device("cpu")) is default_alibi_slopes(
        4, torch.device("cpu"))


def test_load_zoo_checkpoint_reads_a_saved_transformers_model(tmp_path):
    """``load_zoo_checkpoint`` on a ``save_pretrained`` directory (read by the
    port's own safetensors reader) gives the packer's params bit for bit."""
    model, sd = _state_dict("pack_gpt2_state_dict")
    model.save_pretrained(tmp_path, safe_serialization=True)
    cfg = tgpt2.GPT2_REGISTRY["debug-gpt2"]
    got = _flat(treg.load_zoo_checkpoint("debug-gpt2", str(tmp_path), dtype=torch.float32,
                                         device="cpu"))
    want = _flat(tgpt2.pack_gpt2_state_dict(sd, cfg, device="cpu"))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
