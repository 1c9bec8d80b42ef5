"""Speculative serving of the GPT-2 and NeoX families (``SpecEngine``'s
``forward_fn`` and ``draft_forward_fn``), held to the JAX package's.

* Greedy ``SpecEngine`` with a ``debug-gpt2`` target and a ``debug-neox``
  draft (vocabulary 512 both; float32 weights from ``convert.py``, bf16
  target KV as the JAX CLI's default, the draft cache in bf16 as JAX's)
  commits the tokens of JAX's ``SpecEngine`` with the same hooks and of the
  port's plain ``Engine(forward_fn=gpt2_forward)``; the round the CUDA graph
  captures, run eagerly over its static buffers, gives the loop's tokens;
  the zoo draft gets its one float32 head copy.
* ``cli.serve --model_name debug-tiny --draft_model debug-gpt2 --device cpu``
  (a Llama target with a zoo draft of the same vocabulary) runs and prints
  the JAX CLI's ``spec_*`` fields.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import gpt2 as jgpt2
from llm_fp8_tpu.models import neox as jneox
from llm_fp8_tpu.serving import EngineConfig as JEngineConfig
from llm_fp8_tpu.serving import SpecEngine as JSpecEngine
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import gpt2 as tgpt2
from llm_fp8_tpu_torch.models import neox as tneox
from llm_fp8_tpu_torch.models.zoo import HEAD_F32
from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams, SpecEngine

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

TARGET, DRAFT = "debug-gpt2", "debug-neox"
MAX_NEW = 10


@pytest.fixture(scope="module")
def models():
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jt = jgpt2.init_gpt2_params(jgpt2.GPT2_REGISTRY[TARGET], jax.random.PRNGKey(0))
    jd = jneox.init_neox_params(jneox.NEOX_REGISTRY[DRAFT], jax.random.PRNGKey(1))
    return (jt, jd), (params_from_numpy(np_tree(jt)), params_from_numpy(np_tree(jd)))


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 512, n).astype(np.int32) for n in (6, 13, 9)]


def _run(engine, max_new=MAX_NEW):
    reqs = [engine.add_request(p, SamplingParams(max_new_tokens=max_new)) for p in _prompts()]
    engine.run()
    return [r.output for r in reqs]


class BodyRounds(SpecEngine):
    """Runs the round the CUDA graph captures, eagerly over its static
    buffers, where the card would replay it."""

    def _run_spec_rounds(self, toks, lens, rounds):
        self._toks.copy_(toks)
        self._lens.copy_(lens)
        self._row.zero_()
        for _ in range(rounds):
            self._graph_round()
        return (self._committed[:rounds].numpy().copy(), self._n_commit[:rounds].numpy().copy(),
                self._toks.numpy().copy(), self._lens.numpy().copy())


def test_greedy_zoo_spec_engine_matches_jax_and_plain_greedy(models):
    (jt, jd), (tt, td) = models
    jcfg, jdcfg = jgpt2.GPT2_REGISTRY[TARGET], jneox.NEOX_REGISTRY[DRAFT]
    tcfg, tdcfg = tgpt2.GPT2_REGISTRY[TARGET], tneox.NEOX_REGISTRY[DRAFT]
    want_jax = _run(JSpecEngine(jt, jcfg, jd, jdcfg,
                                JEngineConfig(max_slots=2, max_seq_len=128,
                                              prefill_buckets=(16,), kv_dtype=jnp.bfloat16,
                                              attn_impl="ref"),
                                gamma=3, forward_fn=jgpt2.gpt2_forward,
                                draft_forward_fn=jneox.neox_forward))
    ecfg = EngineConfig(max_slots=2, max_seq_len=128, prefill_buckets=(16,),
                        kv_dtype=torch.bfloat16)
    want_plain = _run(Engine(tt, tcfg, ecfg, device="cpu", forward_fn=tgpt2.gpt2_forward))
    hooks = dict(gamma=3, device="cpu", forward_fn=tgpt2.gpt2_forward,
                 draft_forward_fn=tneox.neox_forward)
    spec = SpecEngine(tt, tcfg, td, tdcfg, ecfg, **hooks)
    assert spec.dcache.k.dtype == torch.bfloat16 and spec.cache is not None
    got = _run(spec)
    assert got == want_plain
    assert got == want_jax
    assert spec.rounds_total > 0 and any(a < 3 for a in spec.accepted_histogram)
    assert _run(BodyRounds(tt, tcfg, td, tdcfg, ecfg, **hooks)) == want_plain
    # A bf16 draft (as the CLI loads it) gets one float32 copy of its head.
    bf16 = {k: v if k == "layers" else v.to(torch.bfloat16) for k, v in td.items()}
    assert SpecEngine(tt, tcfg, bf16, tdcfg, ecfg, **hooks).dparams[HEAD_F32].dtype == \
        torch.float32 and HEAD_F32 not in bf16
    with pytest.raises(ValueError, match="share a vocabulary"):
        SpecEngine(tt, tcfg, td, tneox.NEOX_REGISTRY["pythia-1.4b"], ecfg, **hooks)


def test_serve_cli_serves_a_llama_target_with_a_zoo_draft(capsys):
    from llm_fp8_tpu_torch.cli.serve import main

    done = main(["--model_name", "debug-tiny", "--random_init", "--device", "cpu",
                 "--draft_model", "debug-gpt2", "--gamma", "3", "--num_requests", "3",
                 "--prompt_len", "10", "--max_new_tokens", "6", "--max_slots", "2",
                 "--max_seq_len", "64"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["generated_tokens"] == 18
    assert out["spec_gamma"] == 3
    assert out["spec_tokens_per_round"] == pytest.approx(out["spec_mean_accepted"] + 1)
    assert all(len(r.output) == 6 for r in done)
