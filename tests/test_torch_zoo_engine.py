"""The serving engine with ``forward_fn`` (the GPT-2 and NeoX families), on
the CPU.

* ``Engine(forward_fn=...)`` for debug-neox and debug-btlm (bf16 and e4m3
  KV, on the KVCache path) against the JAX engine on the same weights:
  three requests of mixed lengths over two slots, one step a dispatch, every
  step's logits within 1e-3 of the largest |logit| (float32 compute; a stored
  K/V value may round one step of the cache dtype the other way, as in
  ``test_torch_zoo_models.py``), and the greedy tokens equal wherever the
  JAX top-2 gap exceeds 4x that. The engine's tokens equal a manual loop of
  the forward over a one-sequence ``KVCache``, under the same rule.
* The step the CUDA graph captures, run eagerly over its static buffers,
  commits the loop's tokens (greedy bursts).
* int8 KV is refused for a zoo model (no calibrated scales off the arena).
* ``cli.serve --model_name debug-gpt2 --random_init --device cpu`` prints
  the JAX CLI's keys; ``--paged`` with a zoo name (Gemma's, MoE's and
  MLA's too) exits with the JAX CLI's reason.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import gpt2 as jgpt2
from llm_fp8_tpu.models import neox as jneox
from llm_fp8_tpu.serving import engine as jengine
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import gpt2 as tgpt2
from llm_fp8_tpu_torch.models import neox as tneox
from llm_fp8_tpu_torch.models.llama import init_kv_cache
from llm_fp8_tpu_torch.serving import engine as tengine

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

TOL = 1e-3
PROMPT_LENS = (5, 12, 20)
MAX_NEW = 6
MODELS = {"debug-neox": (jneox.NEOX_REGISTRY, jneox.init_neox_params, jneox.neox_forward,
                         tneox.NEOX_REGISTRY, tneox.neox_forward),
          "debug-btlm": (jgpt2.GPT2_REGISTRY, jgpt2.init_gpt2_params, jgpt2.gpt2_forward,
                         tgpt2.GPT2_REGISTRY, tgpt2.gpt2_forward)}


def _model(name):
    jreg, jinit, jfwd, treg, tfwd = MODELS[name]
    jp = jinit(jreg[name], jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jreg[name], jp, jfwd, treg[name], tp, tfwd


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


def _prompts(vocab):
    rng = np.random.default_rng(9)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(cls, mod, params, cfg, kv, **kw):
    eng = cls(params, cfg, mod.EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,),
                                            kv_dtype=kv, decode_burst=1), **kw)
    eng.rows = []
    reqs = [eng.add_request(p, mod.SamplingParams(max_new_tokens=MAX_NEW))
            for p in _prompts(cfg.vocab_size)]
    eng.run()
    return eng, reqs


def _guarded_equal(want_rows, want_tokens, got_tokens):
    """Tokens equal wherever the reference's top-2 gap exceeds 4·TOL·top;
    after a near-tie that went the other way the texts part and the
    comparison stops. Returns how many tokens were held."""
    held = 0
    top = max(np.abs(r).max() for r in want_rows)
    for step, row in enumerate(want_rows):
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] > 4 * TOL * top:
            held += 1
            assert got_tokens[step] == want_tokens[step], step
        elif got_tokens[step] != want_tokens[step]:
            break
    return held


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
@pytest.mark.parametrize("name", list(MODELS))
def test_engine_forward_fn_matches_jax_engine_and_a_manual_loop(name, kv):
    jcfg, jp, jfwd, tcfg, tp, tfwd = _model(name)
    jeng, jreqs = _serve(JaxRecorder, jengine, jp, jcfg, kv, forward_fn=jfwd)
    teng, treqs = _serve(TorchRecorder, tengine, tp, tcfg, kv, forward_fn=tfwd, device="cpu")
    assert not teng._fp8_arena and not jeng._fp8_arena and teng.cache is not None
    assert teng.cache.k.dtype == (torch.bfloat16 if kv == "bf16" else torch.float8_e4m3fn)
    held = 0
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.error is None and len(tr.output) == MAX_NEW
        jrows, trows = jeng.rows[jr.request_id], teng.rows[tr.request_id]
        assert len(jrows) == len(trows) == MAX_NEW
        top = max(np.abs(r).max() for r in jrows)
        for step, (jrow, trow) in enumerate(zip(jrows, trows)):
            np.testing.assert_allclose(trow, jrow, rtol=0, atol=TOL * top,
                                       err_msg=f"request {jr.request_id} step {step}")
            if tr.output[step] != jr.output[step]:
                break
        held += _guarded_equal(jrows, jr.output, tr.output)
        # The same request through the forward alone, one sequence a cache.
        prompt = _prompts(tcfg.vocab_size)[tr.request_id]
        cache = init_kv_cache(tcfg, 1, 64, dtype=teng.cache.k.dtype, device="cpu")
        padded = torch.zeros((1, 32), dtype=torch.int64)
        padded[0, :len(prompt)] = torch.from_numpy(prompt)
        n = len(prompt)
        logits, cache = tfwd(teng.params, padded, tcfg, cache=cache, start_pos=0,
                             kv_lens=torch.tensor([n]))
        rows, toks = [logits[0, n - 1].numpy()], [int(logits[0, n - 1].argmax())]
        for i in range(MAX_NEW - 1):
            logits, cache = tfwd(teng.params, torch.tensor([[toks[-1]]]), tcfg, cache=cache,
                                 start_pos=torch.tensor([n + i]), kv_lens=torch.tensor([n + i + 1]))
            rows.append(logits[0, 0].numpy())
            toks.append(int(logits[0, 0].argmax()))
        held += _guarded_equal(rows, toks, tr.output)
    assert held > 0


class BodySteps(tengine.Engine):
    """Runs the step the CUDA graph captures, eagerly over its static
    buffers, where the card would replay it."""

    def _run_decode_burst(self, toks, lens, steps):
        self._toks.copy_(toks)
        self._lens.copy_(lens)
        self._row.zero_()
        for _ in range(steps):
            self._graph_step()
        return self._burst_out[:steps].numpy().copy(), self._logits


@pytest.mark.parametrize("kv", ["bf16", "fp8"])
def test_graph_step_body_matches_the_loop_for_a_zoo_model(kv):
    _, _, _, tcfg, tp, tfwd = _model("debug-btlm")
    ecfg = tengine.EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,),
                                kv_dtype=kv, decode_burst=32)
    outs = []
    for cls in (tengine.Engine, BodySteps):
        eng = cls(tp, tcfg, ecfg, device="cpu", forward_fn=tfwd)
        reqs = [eng.add_request(p, tengine.SamplingParams(max_new_tokens=10))
                for p in _prompts(tcfg.vocab_size)]
        eng.run()
        assert all(r.done and r.error is None and len(r.output) == 10 for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


def test_int8_kv_is_refused_for_a_zoo_model():
    _, _, _, tcfg, tp, tfwd = _model("debug-neox")
    with pytest.raises(ValueError, match="int8 KV requires the fused-arena"):
        tengine.Engine(tp, tcfg, tengine.EngineConfig(kv_dtype="int8", max_seq_len=64),
                       device="cpu", forward_fn=tfwd)


def test_engine_keeps_one_float32_copy_of_the_tied_head():
    _, _, _, tcfg, tp, tfwd = _model("debug-btlm")
    tp = {**tp, "wte": tp["wte"].to(torch.bfloat16)}
    eng = tengine.Engine(tp, tcfg, tengine.EngineConfig(max_seq_len=64, prefill_buckets=(32,)),
                         device="cpu", forward_fn=tfwd)
    assert torch.equal(eng.params["head_f32"], tp["wte"].float())
    assert "head_f32" not in tp  # the caller's tree is not changed


SERVE_ARGS = ["--random_init", "--device", "cpu", "--num_requests", "2", "--prompt_len",
              "10", "--max_new_tokens", "4", "--max_seq_len", "64", "--max_slots", "2"]


def test_serve_cli_serves_a_zoo_model_with_the_jax_keys(capsys):
    from llm_fp8_tpu.cli.serve import main as jax_main
    from llm_fp8_tpu_torch.cli.serve import main

    common = ["--model_name", "debug-gpt2", "--precision", "fp8", "--kv_dtype", "fp8"]
    done = main(common + SERVE_ARGS)
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_main(common + ["--random_init", "--num_requests", "2", "--prompt_len", "10",
                       "--max_new_tokens", "4", "--max_seq_len", "64", "--max_slots", "2"])
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs)
    assert ours["requests"] == 2 and ours["generated_tokens"] == 8
    assert ours["kv_dtype"] == "float8_e4m3fn" == theirs["kv_dtype"]
    assert all(len(r.output) == 4 for r in done)


def test_serve_cli_refuses_paged_for_a_zoo_model():
    from llm_fp8_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit, match="Llama-family paged decode path"):
        main(["--model_name", "debug-falcon", "--paged"] + SERVE_ARGS)
    with pytest.raises(SystemExit, match="Llama-family paged decode path"):
        main(["--model_name", "debug-gemma2", "--paged"] + SERVE_ARGS)
    with pytest.raises(SystemExit, match="Llama-family paged decode path"):
        main(["--model_name", "debug-mixtral", "--paged"] + SERVE_ARGS)
    with pytest.raises(SystemExit, match="Llama-family paged decode path"):
        main(["--model_name", "debug-mla", "--paged"] + SERVE_ARGS)
