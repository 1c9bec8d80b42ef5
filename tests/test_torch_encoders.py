"""The BERT and ViT encoders of the port against the JAX package, on the CPU.

* The registries equal JAX's, field by field, and the properties.
* ``bert_forward`` (with and without ``lens``, with token types), the pooler
  and ``bert_mlm_logits``, and ``vit_forward``/``patchify``, against JAX's
  (attention through ``attn_impl="ref"``, the plain golden) on the same numpy
  weights (random biases and norms too) and inputs. Both compute in float32:
  within 1e-5 of each output's largest |value| (sum orders; BERT's rows past
  ``lens`` are zeroed on both sides, as JAX's own tests compare).
* fp8 weights made as JAX's tests make them (``quantize(w, E4M3,
  axes=(1,))`` on ``w_qkv``, ``w_out``, ``w_fc``, ``w_proj``): codes and
  scales bit for bit with JAX's, and the outputs within 1e-3 of the largest
  |value| on the dequant route (``LLM_FP8_QDOT=xla``) and on the fp8-operand
  route (``fp8native``: x quantized per row to e4m3 on both sides, where one
  float32 input that straddles a rounding boundary moves a code).
* The packers bit for bit with JAX's on the same state dict, and the port's
  forwards on them against ``transformers`` models built from a config in the
  test (``BertForMaskedLM``, ``BertModel``, ``ViTModel``), with JAX's own
  tolerances (2e-4; ``tests/test_bert.py``, ``tests/test_vit.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import bert as jbert
from llm_fp8_tpu.models import vit as jvit
from llm_fp8_tpu.quant import quantize as jax_quantize
from llm_fp8_tpu.quant.formats import E4M3 as J_E4M3
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import bert as tbert
from llm_fp8_tpu_torch.models import vit as tvit
from llm_fp8_tpu_torch.quant import QTensor, quantize
from llm_fp8_tpu_torch.quant.formats import E4M3

torch.set_num_threads(1)  # one thread per xdist worker (see test_torch_zoo_models.py)

BERT = jbert.BERT_REGISTRY["debug-bert"]
VIT = jvit.VIT_REGISTRY["debug-vit"]
FP8_SITES = ("w_qkv", "w_out", "w_fc", "w_proj")


def numpy_tree(tree):
    if isinstance(tree, JQTensor):
        return dict(qvalue=np.asarray(tree.qvalue), scale=np.asarray(tree.scale),
                    fmt=tree.fmt.name, block_size=tree.block_size,
                    block_axis=tree.block_axis, pack_axis=tree.pack_axis)
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def random_tree(tree, seed):
    """Every leaf of a JAX init tree redrawn from numpy: weights N(0, 0.05),
    norms 1 + N(0, 0.1), biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def draw(name, a):
        a = np.asarray(a)
        if name.endswith("_w") and "ln" in name:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        std = 0.02 if name.startswith("b_") or name.endswith("_b") or "bias" in name else 0.05
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    def redraw(t):
        return {k: redraw(v) if isinstance(v, dict) else draw(k, v) for k, v in t.items()}

    return redraw(tree)


def within(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def test_registries_match_jax():
    for jreg, treg in ((jbert.BERT_REGISTRY, tbert.BERT_REGISTRY),
                       (jvit.VIT_REGISTRY, tvit.VIT_REGISTRY)):
        assert set(jreg) == set(treg)
        for name in jreg:
            assert dataclasses.asdict(jreg[name]) == dataclasses.asdict(treg[name])
            assert jreg[name].head_dim == treg[name].head_dim
    for name, c in jvit.VIT_REGISTRY.items():
        t = tvit.VIT_REGISTRY[name]
        assert (c.num_patches, c.patch_dim) == (t.num_patches, t.patch_dim)
    assert tvit.VIT_REGISTRY["vit-base-patch16-224"].num_patches + 1 == 197
    with pytest.raises(NotImplementedError, match="auto"):
        tbert.bert_forward({"wte": torch.zeros(1)}, torch.zeros((1, 1)), BERT, attn_impl="ref")


def _bert_inputs(seed):
    rng = np.random.default_rng(seed)
    B, S = 3, 16
    lens = np.array([16, 9, 3], np.int32)
    tokens = rng.integers(0, BERT.vocab_size, (B, S)).astype(np.int32)
    types = (np.arange(S)[None] >= np.array([8, 4, 1])[:, None]).astype(np.int32)
    return tokens, types, lens


def _bert_both(params_np, tokens, types, lens):
    """(JAX, port) sequence output, pooled and MLM logits."""
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    jkw = dict(attn_impl="ref")
    tkw = {}
    if lens is not None:
        jkw["lens"] = jnp.asarray(lens)
        tkw["lens"] = torch.from_numpy(lens)
    if types is not None:
        jkw["token_type_ids"] = jnp.asarray(types)
        tkw["token_type_ids"] = torch.from_numpy(types)
    jseq, jpool = jbert.bert_forward(jp, jnp.asarray(tokens), BERT, **jkw)
    jlog = jbert.bert_mlm_logits(jp, jseq, BERT)
    tp = params_from_numpy(params_np)
    tseq, tpool = tbert.bert_forward(tp, torch.from_numpy(tokens), BERT, **tkw)
    tlog = tbert.bert_mlm_logits(tp, tseq, BERT)
    return (jseq, jpool, jlog), (tseq, tpool, tlog)


@pytest.mark.parametrize("case", ["plain", "lens_and_types"])
def test_bert_forward_matches_jax(case):
    params = random_tree(numpy_tree(jbert.init_bert_params(BERT, jax.random.PRNGKey(0))), 1)
    tokens, types, lens = _bert_inputs(2)
    if case == "plain":
        types = lens = None
    (jseq, jpool, jlog), (tseq, tpool, tlog) = _bert_both(params, tokens, types, lens)
    assert tseq.dtype == torch.float32 and tlog.dtype == torch.float32
    assert tlog.shape == (3, 16, BERT.vocab_size)
    within(tseq.numpy(), jseq, 1e-5)
    within(tpool.numpy(), jpool, 1e-5)
    within(tlog.numpy(), jlog, 1e-5)
    if lens is not None:  # padded rows zeroed on both sides
        assert (tseq[1, 9:] == 0).all() and (tseq[2, 3:] == 0).all()


@pytest.mark.parametrize("route", ["xla", "fp8native"])
def test_bert_fp8_weights_match_jax(route, monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "1" if route == "fp8native" else "0")
    monkeypatch.setenv("LLM_FP8_QDOT", route)
    params = random_tree(numpy_tree(jbert.init_bert_params(BERT, jax.random.PRNGKey(0))), 3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for name in FP8_SITES:
        jparams["layers"][name] = jax_quantize(jparams["layers"][name], J_E4M3, axes=(1,))
        tq = quantize(torch.from_numpy(params["layers"][name]), E4M3, axes=(1,))
        jq = numpy_tree(jparams["layers"][name])
        assert np.array_equal(tq.qvalue.view(torch.uint8).numpy(), jq["qvalue"].view(np.uint8))
        assert np.array_equal(tq.scale.numpy(), jq["scale"])
    tokens, types, lens = _bert_inputs(4)
    jp, tp = jparams, params_from_numpy(numpy_tree(jparams))
    assert isinstance(tp["layers"]["w_qkv"], QTensor)
    jseq, jpool = jbert.bert_forward(jp, jnp.asarray(tokens), BERT, lens=jnp.asarray(lens),
                                     token_type_ids=jnp.asarray(types), attn_impl="ref")
    tseq, tpool = tbert.bert_forward(tp, torch.from_numpy(tokens), BERT,
                                     lens=torch.from_numpy(lens),
                                     token_type_ids=torch.from_numpy(types))
    within(tseq.numpy(), jseq, 1e-3)
    within(tpool.numpy(), jpool, 1e-3)
    within(tbert.bert_mlm_logits(tp, tseq, BERT).numpy(), jbert.bert_mlm_logits(jp, jseq, BERT),
           1e-3)


def _pixels(seed, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, VIT.num_channels, VIT.image_size,
                                VIT.image_size)).astype(np.float32)


@pytest.mark.parametrize("weights", ["float32", "fp8"])
def test_vit_forward_matches_jax(weights):
    params = random_tree(numpy_tree(jvit.init_vit_params(VIT, jax.random.PRNGKey(1))), 5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    px = _pixels(6)
    assert np.array_equal(tvit.patchify(torch.from_numpy(px), VIT).numpy(),
                          np.asarray(jvit.patchify(jnp.asarray(px), VIT)))
    if weights == "fp8":
        for name in FP8_SITES:
            jparams["layers"][name] = jax_quantize(jparams["layers"][name], J_E4M3, axes=(1,))
    want = jvit.vit_forward(jparams, jnp.asarray(px), VIT, attn_impl="ref")
    got = tvit.vit_forward(params_from_numpy(numpy_tree(jparams)), torch.from_numpy(px), VIT)
    assert got.shape == (2, 1 + VIT.num_patches, VIT.hidden_size)
    within(got.numpy(), want, 1e-5 if weights == "float32" else 1e-3)


def _hf_bert_config():
    from transformers import BertConfig as HFConfig

    return HFConfig(vocab_size=BERT.vocab_size, hidden_size=BERT.hidden_size,
                    intermediate_size=BERT.intermediate_size,
                    num_hidden_layers=BERT.num_layers, num_attention_heads=BERT.num_heads,
                    max_position_embeddings=BERT.max_position_embeddings,
                    type_vocab_size=BERT.type_vocab_size, layer_norm_eps=BERT.ln_eps,
                    hidden_act="gelu", hidden_dropout_prob=0.0,
                    attention_probs_dropout_prob=0.0)


def _same_tree(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _same_tree(t[k], j[k])
        return
    assert np.array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("head", ["mlm", "mlm_padded", "pooler"])
def test_bert_packer_matches_jax_and_hf(head):
    from transformers import BertForMaskedLM, BertModel

    torch.manual_seed(0 if head != "pooler" else 1)
    model = (BertModel(_hf_bert_config()) if head == "pooler"
             else BertForMaskedLM(_hf_bert_config())).eval()
    prefix = "bert." if head == "pooler" else ""
    sd = {prefix + k: v.detach().numpy() for k, v in model.state_dict().items()}
    tp = tbert.pack_bert_state_dict(sd, BERT, device="cpu")
    _same_tree(tp, jbert.pack_bert_state_dict({k: jnp.asarray(v) for k, v in sd.items()}, BERT))
    S = 16 if head == "mlm_padded" else 12
    lens = np.array([16, 9, 3], np.int32)
    tokens = np.random.default_rng(0).integers(0, BERT.vocab_size, (3, S)).astype(np.int64)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
    with torch.no_grad():
        if head == "pooler":
            out = model(torch.from_numpy(tokens))
            seq, pooled = tbert.bert_forward(tp, torch.from_numpy(tokens), BERT)
            torch.testing.assert_close(seq, out.last_hidden_state, rtol=2e-4, atol=2e-4)
            torch.testing.assert_close(pooled, out.pooler_output, rtol=2e-4, atol=2e-4)
            return
        kw = {}
        if head == "mlm_padded":
            tokens = tokens * mask
            kw = {"lens": torch.from_numpy(lens)}
        want = model(torch.from_numpy(tokens), attention_mask=torch.from_numpy(mask)
                     if kw else None).logits
        seq, _ = tbert.bert_forward(tp, torch.from_numpy(tokens), BERT, **kw)
        got = tbert.bert_mlm_logits(tp, seq, BERT)
    for b in range(3):  # HF computes garbage past lens
        n = int(lens[b]) if kw else S
        torch.testing.assert_close(got[b, :n], want[b, :n], rtol=2e-4, atol=2e-4)


def test_vit_packer_matches_jax_and_hf():
    from transformers import ViTConfig as HFConfig
    from transformers import ViTModel

    torch.manual_seed(5)
    hf_cfg = HFConfig(image_size=VIT.image_size, patch_size=VIT.patch_size,
                      num_channels=VIT.num_channels, hidden_size=VIT.hidden_size,
                      intermediate_size=VIT.intermediate_size,
                      num_hidden_layers=VIT.num_layers, num_attention_heads=VIT.num_heads,
                      hidden_act="gelu", hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, layer_norm_eps=VIT.ln_eps)
    model = ViTModel(hf_cfg, add_pooling_layer=False).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tp = tvit.pack_vit_state_dict(sd, VIT, device="cpu")
    _same_tree(tp, jvit.pack_vit_state_dict({k: jnp.asarray(v) for k, v in sd.items()}, VIT))
    px = torch.from_numpy(_pixels(0))
    with torch.no_grad():
        want = model(px).last_hidden_state
        got = tvit.vit_forward(tp, px, VIT)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
