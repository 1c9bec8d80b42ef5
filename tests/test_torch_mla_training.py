"""The MLA family (``models/mla.py``) through the port's engines, trainer and
CLIs, against the JAX package's on the CPU (JAX's attention through its
reference, never Pallas interpret mode).

* ``Engine(forward_fn=mla_forward)`` against the JAX engine with its
  ``forward_fn`` on the same weights, with bf16 and e4m3 latent caches (the
  KVCache path), both forwards in float32 compute (the MoE engine test's
  reasoning: routing flips where bf16 roundings meet near-ties): every
  step's logits within 1e-3 of the largest |logit| up to the first token
  where the streams part, and the greedy tokens equal wherever the JAX
  top-2 gap exceeds 4x that. The bf16 engine (the served default) commits
  the tokens of a manual loop of the forward over one-sequence caches.
* ``SpecEngine`` with an MLA target (bf16) and an MLA or a Llama-family
  draft of the same vocabulary commits the plain engine's greedy tokens.
* One bf16-recipe ``Trainer`` step against JAX's ``Trainer(forward_fn=
  mla_forward)`` (float32 master weights, bf16 compute, a padded batch with
  its mask): the loss and the router aux within 1e-3 relative, every
  gradient (``w_router`` and ``w_kv_b`` of both groups included) within
  2e-2 of its largest |value| (the MoE family's bf16 limits); then one
  ``train_step`` a side. remat none, full and dots give the same loss, aux
  and gradients bit for bit (with dropout 0.1 too). An fp8 recipe is
  refused with the reason.
* The CLIs: ``cli.serve`` serves debug-mla and debug-mla-q (fp8 weights and
  latent cache) and drafts with an MLA or a Llama draft, refuses ``--paged``
  and int8 KV (as the JAX CLI and engine); ``cli.train`` trains debug-mla on
  the bf16 recipe, logs the router aux and writes the HF export, which
  ``transformers`` loads.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import mla as jmla
from llm_fp8_tpu.serving import engine as jengine
from llm_fp8_tpu.training import TrainConfig as JTrainConfig
from llm_fp8_tpu.training import Trainer as JTrainer
from llm_fp8_tpu.training.quant_state import make_sinks
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import mla as tmla
from llm_fp8_tpu_torch.models import resolve_model
from llm_fp8_tpu_torch.models.llama import init_kv_cache
from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams, SpecEngine
from llm_fp8_tpu_torch.serving import engine as tengine
from llm_fp8_tpu_torch.training import TrainConfig, Trainer
from llm_fp8_tpu_torch.training.trainer import _leaves

# One torch thread per test process (see test_torch_zoo_models.py).
torch.set_num_threads(1)

TOL = 1e-3
NAMES = ("debug-mla", "debug-mla-q")
PROMPT_LENS = (5, 12, 20)
MAX_NEW = 6


@functools.lru_cache(maxsize=None)
def weights(name, dtype="float32"):
    """A numpy tree of ``name`` from JAX's init, cast to ``dtype`` by JAX."""
    p = jmla.init_mla_params(jmla.MLA_REGISTRY[name], jax.random.PRNGKey(7), dtype=jnp.float32)
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(dtype)), p)


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 512, n).astype(np.int32) for n in PROMPT_LENS]


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


def _serve(cls, mod, params, cfg, kv, **kw):
    eng = cls(params, cfg, mod.EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,),
                                            kv_dtype=kv, decode_burst=1), **kw)
    eng.rows = []
    reqs = [eng.add_request(p, mod.SamplingParams(max_new_tokens=MAX_NEW)) for p in _prompts()]
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_jax_engine(name, kv):
    tree = weights(name, "bfloat16")
    jfwd = functools.partial(jmla.mla_forward, compute_dtype=jnp.float32)
    tfwd = functools.partial(tmla.mla_forward, compute_dtype=torch.float32)
    jeng, jreqs = _serve(JaxRecorder, jengine, jax_tree(tree), jmla.MLA_REGISTRY[name], kv,
                         forward_fn=jfwd)
    teng, treqs = _serve(TorchRecorder, tengine, params_from_numpy(tree),
                         tmla.MLA_REGISTRY[name], kv, forward_fn=tfwd, device="cpu")
    cfg = tmla.MLA_REGISTRY[name]
    assert not teng._fp8_arena and teng.cache.k.dtype == (
        torch.bfloat16 if kv == "bf16" else torch.float8_e4m3fn)
    assert teng.cache.k.shape[-1] == cfg.kv_lora_rank
    assert teng.cache.v.shape[-1] == cfg.qk_rope_head_dim
    held = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.output) == MAX_NEW
        jrows, trows = jeng.rows[jr.request_id], teng.rows[tr.request_id]
        top = max(np.abs(r).max() for r in jrows)
        for step, (jrow, trow) in enumerate(zip(jrows, trows)):
            np.testing.assert_allclose(trow, jrow, rtol=0, atol=TOL * top,
                                       err_msg=f"request {jr.request_id} step {step}")
            gap = np.diff(np.sort(jrow)[-2:])[0]
            if gap > 4 * TOL * top:
                held += 1
                assert tr.output[step] == jr.output[step], (jr.request_id, step)
            if tr.output[step] != jr.output[step]:
                break  # a near-tie went the other way: the texts part here
    assert held > 0


def test_bf16_engine_commits_a_manual_loop_of_the_forward():
    """The served default (bf16 compute, e4m3 latent cache): the engine's
    greedy tokens equal those of a loop of the forward over a one-sequence
    cache, wherever that loop's top-2 gap exceeds 0.05 (the engine's batched
    steps and the loop's single rows round bf16 products differently)."""
    name = "debug-mla-q"
    cfg = tmla.MLA_REGISTRY[name]
    params = params_from_numpy(weights(name, "bfloat16"))
    eng = Engine(params, cfg, EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,),
                                           kv_dtype="fp8"), device="cpu",
                 forward_fn=tmla.mla_forward)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=MAX_NEW)) for p in _prompts()]
    eng.run()
    held = 0
    for req, prompt in zip(reqs, _prompts()):
        assert req.done and req.error is None and len(req.output) == MAX_NEW
        cache = init_kv_cache(cfg, 1, 64, dtype=torch.float8_e4m3fn, device="cpu")
        padded = torch.zeros((1, 32), dtype=torch.int64)
        padded[0, :len(prompt)] = torch.from_numpy(prompt)
        n = len(prompt)
        logits, cache = tmla.mla_forward(params, padded, cfg, cache=cache, start_pos=0,
                                         kv_lens=torch.tensor([n]))
        row = logits[0, n - 1]
        for i in range(MAX_NEW):
            top2 = row.topk(2).values
            if float(top2[0] - top2[1]) > 0.05:
                held += 1
                assert int(row.argmax()) == req.output[i], (req.request_id, i)
            if int(row.argmax()) != req.output[i]:
                break
            logits, cache = tmla.mla_forward(params, torch.tensor([[req.output[i]]]), cfg,
                                             cache=cache, start_pos=torch.tensor([n + i]),
                                             kv_lens=torch.tensor([n + i + 1]))
            row = logits[0, 0]
    assert held > 0


@pytest.mark.parametrize("target,draft", [("debug-mla", "debug-mla-q"),
                                          ("debug-mla-q", "debug-tiny")])
def test_spec_engine_gives_the_plain_engines_greedy_tokens(target, draft):
    t, d = resolve_model(target), resolve_model(draft)
    tparams = params_from_numpy(weights(target, "bfloat16"))
    dparams = d.init_fn(d.cfg, device="cpu", seed=3)
    ecfg = EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,), kv_dtype="bf16")
    eng = Engine(tparams, t.cfg, ecfg, device="cpu", forward_fn=t.forward_fn)
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8)) for p in _prompts()]
    eng.run()
    want = [r.output for r in reqs]
    spec = SpecEngine(tparams, t.cfg, dparams, d.cfg, ecfg, gamma=3, device="cpu",
                      forward_fn=t.forward_fn, draft_forward_fn=d.forward_fn)
    reqs = [spec.add_request(p, SamplingParams(max_new_tokens=8)) for p in _prompts()]
    spec.run()
    assert [r.output for r in reqs] == want and spec.rounds_total > 0
    if d.forward_fn is tmla.mla_forward:  # the draft's cache is its latent one
        assert spec.dcache.k.shape[-1] == d.cfg.kv_lora_rank


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _batch(seed, B=2, S=24):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, S), np.int32)
    mask[1, -5:] = 0
    return {"input_ids": rng.randint(0, 512, (B, S)).astype(np.int32), "attention_mask": mask}


@pytest.mark.parametrize("name", NAMES)
def test_trainer_step_matches_jax(name):
    """The loss, the router aux and every parameter's gradient: JAX's from
    the value_and_grad of its Trainer's own ``_forward_loss``, the port's
    from ``Trainer.loss_and_grads``; then one ``train_step`` a side."""
    jcfg, tcfg = jmla.MLA_REGISTRY[name], tmla.MLA_REGISTRY[name]
    tree = weights(name)
    kw = dict(recipes="bf16", warmup_steps=0, total_steps=10, learning_rate=1e-3)
    b = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jt = JTrainer(jcfg, JTrainConfig(**kw), forward_fn=jmla.mla_forward)
    js = jt.init_state(jax_tree(tree))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jt._forward_loss, has_aux=True))(
        js.params, make_sinks(jcfg), jb, js.qstate, js.step)
    _, _, jaux = jmla.mla_forward(js.params, jb["input_ids"], jcfg, return_router_aux=True,
                                  token_mask=jb["attention_mask"], attn_impl="ref")
    pt = Trainer(tcfg, TrainConfig(**kw), device="cpu", forward_fn=tmla.mla_forward)
    ps = pt.init_state(params_from_numpy(tree))
    loss, n, _, stats, grads, _ = pt.loss_and_grads(ps, b)
    assert np.isnan(float(stats[0]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    np.testing.assert_allclose(float(pt.router_aux), float(jaux), rtol=1e-3)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert sorted(want) == sorted(grads)
    assert {"moe_layers/w_router", "moe_layers/w_kv_b", "dense_layers/w_kv_b"} <= set(grads)
    for path, g in grads.items():
        w = want[path]
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(), err_msg=path)
    js, jm = jt.train_step(js, jb)
    ps, pm = pt.train_step(ps, b)
    assert int(pm["finite"]) == int(jm["finite"]) == 1
    assert int(pm["tokens"]) == int(jm["tokens"]) == int(n)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-3)
    assert float(pm["router_aux"]) > 0


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_modes_are_bit_for_bit(rate):
    cfg = tmla.MLA_REGISTRY["debug-mla-q"]
    params = params_from_numpy(weights("debug-mla-q"))
    b = _batch(3)
    tokens = torch.from_numpy(b["input_ids"]).long()
    mask = torch.from_numpy(b["attention_mask"])
    leaves = [t for _, t in _leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    runs = {}
    for remat in ("none", "full", "dots"):
        logits, _, aux = tmla.mla_forward(params, tokens, cfg, remat=remat, dropout_p=rate,
                                          dropout_seed=9, token_mask=mask,
                                          return_router_aux=True)
        loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 512),
                                                 tokens[:, 1:].reshape(-1)) + 0.001 * aux
        runs[remat] = (loss.detach(), aux.detach(), torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0]), remat
        assert torch.equal(runs[remat][1], runs["none"][1]), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][2], runs["none"][2])), remat


def test_fp8_recipes_are_refused_with_the_reason():
    with pytest.raises(ValueError, match="Llama/Qwen family stack"):
        Trainer(tmla.MLA_REGISTRY["debug-mla"], TrainConfig(recipes="default"),
                device="cpu", forward_fn=tmla.mla_forward)
    from llm_fp8_tpu_torch.cli.train import main

    with pytest.raises(SystemExit, match="implements the Llama/Qwen stack"):
        main(["--model_name", "debug-mla", "--random_init", "--synthetic_samples", "8",
              "--mixed_precision", "fp8", "--device", "cpu"])


# --------------------------------------------------------------------------
# CLIs
# --------------------------------------------------------------------------

SERVE_ARGS = ["--random_init", "--device", "cpu", "--num_requests", "2", "--prompt_len", "10",
              "--max_new_tokens", "4", "--max_seq_len", "64", "--max_slots", "2"]


@pytest.mark.parametrize("name,draft", [("debug-mla", "debug-mla"),
                                        ("debug-mla-q", "debug-tiny")])
def test_serve_cli_serves_and_drafts_mla_and_refuses_paged_and_int8(name, draft, capsys):
    from llm_fp8_tpu_torch.cli.serve import main

    done = main(["--model_name", name, "--precision", "fp8", "--kv_dtype", "fp8"] + SERVE_ARGS)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 2 and out["generated_tokens"] == 8
    assert out["kv_dtype"] == "float8_e4m3fn" and all(len(r.output) == 4 for r in done)
    main(["--model_name", name, "--draft_model", draft, "--gamma", "3"] + SERVE_ARGS)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["generated_tokens"] == 8 and out["spec_gamma"] == 3
    with pytest.raises(SystemExit, match="Llama-family paged decode path"):
        main(["--model_name", name, "--paged"] + SERVE_ARGS)
    with pytest.raises(ValueError, match="int8 KV requires the fused-arena"):
        main(["--model_name", name, "--kv_dtype", "int8"] + SERVE_ARGS)


def test_train_cli_trains_mla_and_writes_the_hf_export(tmp_path, capsys):
    from transformers import AutoModelForCausalLM

    from llm_fp8_tpu_torch.cli.train import main

    report = main(["--model_name", "debug-mla", "--random_init", "--synthetic_samples",
                   "16", "--mixed_precision", "bf16", "--device", "cpu", "--batch_size", "4",
                   "--max_seq_length", "24", "--num_epochs", "1", "--num_warmup_steps", "1",
                   "--remat", "dots", "--log_every", "1", "--log_dir", str(tmp_path / "runs"),
                   "--output_dir", str(tmp_path / "out")])
    assert report["non_finite_steps"] == 0 and report["steps"] >= 2
    train = [json.loads(line)["train"] for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"train"')]
    assert train and all(t["router_aux"] > 0 for t in train)
    cfg = json.loads((tmp_path / "out" / "config.json").read_text())
    assert cfg["model_type"] == "deepseek_v2" and cfg["n_routed_experts"] == 4
    model = AutoModelForCausalLM.from_pretrained(str(tmp_path / "out"))
    assert type(model).__name__ == "DeepseekV2ForCausalLM"
    assert sum(p.numel() for p in model.parameters()) == tmla.MLA_REGISTRY[
        "debug-mla"].num_params()
