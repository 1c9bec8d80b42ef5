"""Training the GPT-2 and NeoX families through the port's ``Trainer``
(``forward_fn``), held to the JAX package's ``Trainer(forward_fn=...)``.

* Two bf16-recipe steps of ``debug-btlm`` (ALiBi, muP, SwiGLU; GPT-2 family)
  and ``debug-falcon`` (multi-query, parallel residual; NeoX family, with
  attention dropout 0.1: both packages draw the same counter hash) from the
  same float32 weights (``convert.py``) and batches: the losses within 1e-5
  relative, NaN activation statistics on both sides (a zoo forward exposes
  no hidden states), each updated parameter within 1% of its update's norm.
  The eval step through ``forward_fn`` gives JAX's token-weighted loss.
* ``remat`` none, full and dots on ``debug-gpt2``, with and without
  dropout: the loss and every gradient equal bit for bit.
* An FP8 recipe with a zoo forward and a tree carrying the serving engine's
  float32 head copy are refused.
* ``cli.train --model_name debug-gpt2 --mixed_precision bf16 --device cpu``
  writes ``params.pkl`` with the JAX CLI's keys and shapes (JAX's own
  ``init_gpt2_params`` tree), and ``--mixed_precision fp8`` exits with the
  JAX CLI's reason.

Both sides compute in float32 and run their attention through the plain
reference (JAX: ``impl="auto"`` on the CPU; the port: ``attention_ref``).
"""
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import gpt2 as jgpt2
from llm_fp8_tpu.models import neox as jneox
from llm_fp8_tpu.training import TrainConfig as JTrainConfig
from llm_fp8_tpu.training import Trainer as JTrainer
from llm_fp8_tpu_torch.convert import params_from_numpy, tree_to_numpy
from llm_fp8_tpu_torch.models import gpt2 as tgpt2
from llm_fp8_tpu_torch.models import neox as tneox
from llm_fp8_tpu_torch.models.zoo import HEAD_F32, with_f32_head
from llm_fp8_tpu_torch.training import TrainConfig, Trainer
from llm_fp8_tpu_torch.training.trainer import _leaves

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

FAMILIES = {"debug-btlm": (jgpt2.GPT2_REGISTRY, jgpt2.init_gpt2_params, jgpt2.gpt2_forward,
                           tgpt2.GPT2_REGISTRY, tgpt2.gpt2_forward, 0.0),
            "debug-falcon": (jneox.NEOX_REGISTRY, jneox.init_neox_params, jneox.neox_forward,
                             tneox.NEOX_REGISTRY, tneox.neox_forward, 0.1)}


def _batch(seed, vocab=512, B=4, S=32):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.int32)
    mask[:, -5:] = 0
    return {"input_ids": rng.randint(0, vocab, (B, S)).astype(np.int32), "attention_mask": mask}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_zoo_train_steps_match_jax(name):
    jreg, jinit, jfwd, treg, tfwd, rate = FAMILIES[name]
    kw = dict(recipes="bf16", warmup_steps=0, total_steps=10, learning_rate=1e-3,
              attention_dropout=rate)
    init = _np(jinit(jreg[name], jax.random.PRNGKey(2), dtype=jnp.float32))
    jt = JTrainer(jreg[name], JTrainConfig(**kw), forward_fn=jfwd)
    js = jt.init_state(jax.tree_util.tree_map(jnp.asarray, init))
    pt = Trainer(treg[name], TrainConfig(**kw), device="cpu", forward_fn=tfwd)
    ps = pt.init_state(params_from_numpy(init))
    for step in range(2):
        b = _batch(step)
        js, jm = jt.train_step(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pt.train_step(ps, b)
        assert int(pm["finite"]) == int(jm["finite"]) == 1
        assert int(pm["tokens"]) == int(jm["tokens"])
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        for key in ("activation_mean", "activation_std"):
            assert math.isnan(float(pm[key])) and math.isnan(float(jm[key]))
    assert ps.step == int(js.step) == 2
    jparams, pparams = dict(_leaves(_np(js.params))), dict(_leaves(tree_to_numpy(ps.params)))
    assert sorted(jparams) == sorted(pparams)
    for path, p0 in _leaves(init):
        update = jparams[path] - p0
        diff = pparams[path] - jparams[path]
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(update) + 1e-7, path
    evals = [_batch(7)]
    want = jt.evaluate(js.params, ({k: jnp.asarray(v) for k, v in b.items()} for b in evals))
    got = pt.evaluate(ps.params, evals)
    assert got["eval_tokens"] == want["eval_tokens"]
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_modes_are_bit_for_bit_on_a_zoo_model(rate):
    cfg = tgpt2.GPT2_REGISTRY["debug-gpt2"]
    params = tgpt2.init_gpt2_params(cfg, dtype=torch.float32, device="cpu", seed=4)
    tokens = torch.from_numpy(_batch(3)["input_ids"]).long()
    leaves = [t for _, t in _leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    runs = {}
    for remat in ("none", "full", "dots"):
        logits = tgpt2.gpt2_forward(params, tokens, cfg, remat=remat, dropout_p=rate,
                                    dropout_seed=9)
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                                                 tokens[:, 1:].reshape(-1))
        runs[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], runs["none"][1])), remat
    with pytest.raises(ValueError, match="unknown remat"):
        tgpt2.gpt2_forward(params, tokens, cfg, remat="everything")
    with pytest.raises(NotImplementedError, match="unroll"):
        ncfg = tneox.NEOX_REGISTRY["debug-neox"]
        tneox.neox_forward(tneox.init_neox_params(ncfg, device="cpu", seed=0), tokens, ncfg,
                           unroll=2)


def test_trainer_refuses_fp8_recipes_and_a_float32_head_copy_for_a_zoo_forward():
    cfg = tgpt2.GPT2_REGISTRY["debug-gpt2"]
    with pytest.raises(ValueError, match="recipes='bf16'"):
        Trainer(cfg, TrainConfig(recipes="default"), device="cpu",
                forward_fn=tgpt2.gpt2_forward)
    params = tgpt2.init_gpt2_params(cfg, dtype=torch.bfloat16, device="cpu", seed=1)
    with pytest.raises(ValueError, match=HEAD_F32):
        Trainer(cfg, TrainConfig(), device="cpu",
                forward_fn=tgpt2.gpt2_forward).init_state(with_f32_head(params))


def test_train_cli_writes_the_jax_params_pickle_and_refuses_fp8(tmp_path):
    from llm_fp8_tpu_torch.cli.train import main

    report = main(["--model_name", "debug-gpt2", "--random_init", "--synthetic_samples", "24",
                   "--mixed_precision", "bf16", "--device", "cpu", "--batch_size", "4",
                   "--max_seq_length", "32", "--num_epochs", "1", "--num_warmup_steps", "1",
                   "--remat", "dots", "--log_dir", str(tmp_path / "runs"),
                   "--output_dir", str(tmp_path / "out")])
    assert report["non_finite_steps"] == 0 and report["steps"] >= 4
    with open(tmp_path / "out" / "params.pkl", "rb") as f:
        got = pickle.load(f)
    want = _np(jgpt2.init_gpt2_params(jgpt2.GPT2_REGISTRY["debug-gpt2"], jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert isinstance(a, np.ndarray) and a.shape == b.shape and a.dtype == np.float32, path
    assert (tmp_path / "out" / "stability_report.json").exists()
    with pytest.raises(SystemExit, match="implements the Llama/Qwen stack; train debug-gpt2 "
                                         "with --mixed_precision bf16"):
        main(["--model_name", "debug-gpt2", "--random_init", "--synthetic_samples", "8",
              "--mixed_precision", "fp8", "--device", "cpu"])
