"""The port's speculative decoding against the JAX package's, on the CPU.

* ``spec_verify`` (host numpy) draws exactly JAX's tokens from the same
  seeded ``np.random.Generator``.
* Greedy ``SpecEngine`` (debug-tiny, float32 weights and KV, three requests
  through two slots) commits the tokens of the JAX ``SpecEngine`` and of the
  port's plain ``Engine``, with a weak draft and with the target as its own
  draft (which accepts ``gamma`` every full round). Sampled verification with
  ``top_k = 1`` reduces to greedy; an EOS stops a slot mid-block; chained
  rounds commit what single rounds commit; the round the CUDA graph captures,
  run eagerly over its static buffers, gives the loop's tokens.
* The on-device acceptance (``leviathan_accept``, with ``draw``) keeps the
  target's filtered distribution: chi-square over 40,000 batched rows, as
  JAX's ``tests/test_speculative.py`` holds its host acceptance.
* ``serve --draft_model`` runs on the CPU and prints the spec fields.

Torch's and JAX's random streams differ, so sampled paths are held by
distributions and greedy paths by token equality.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from llm_fp8_tpu.models import get_config as jget_config
from llm_fp8_tpu.models import init_params as jinit_params
from llm_fp8_tpu.serving import EngineConfig as JEngineConfig
from llm_fp8_tpu.serving import SpecEngine as JSpecEngine
from llm_fp8_tpu.serving.speculative import spec_verify as jspec_verify
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import get_config
from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams, SpecEngine
from llm_fp8_tpu_torch.serving.spec_engine import draw, leviathan_accept
from llm_fp8_tpu_torch.serving.speculative import SpeculativeDecoder, spec_verify

# One torch thread per test process: the suite runs in several pytest-xdist
# workers on a few cores, where torch's default of one thread a core
# oversubscribes them (the port's engine and training tests ran 4-8x longer
# so). Torch's thread count is per process: this holds for every file.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = get_config("debug-tiny")
ECFG = EngineConfig(max_slots=2, max_seq_len=256, kv_dtype=torch.float32,
                    prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def models():
    jc = jget_config("debug-tiny")
    jt = jinit_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    jd = jinit_params(jc, jax.random.PRNGKey(1), dtype=jnp.float32)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (jt, jd), (params_from_numpy(np_tree(jt)), params_from_numpy(np_tree(jd)))


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, rng.integers(4, 14)).astype(np.int32)
            for _ in range(n)]


def _run(engine, prompts, max_new=12):
    reqs = [engine.add_request(p, SamplingParams(max_new_tokens=max_new)) for p in prompts]
    engine.run()
    return [r.output for r in reqs]


def _rand_dist(rng, V):
    p = rng.random(V) ** 3 + 1e-6  # peaked, strictly positive
    return p / p.sum()


def test_spec_verify_draws_jax_tokens_from_the_same_generator():
    V, gamma = 10, 4
    master = np.random.default_rng(11)
    for trial in range(200):
        q = np.stack([_rand_dist(master, V) for _ in range(gamma)])
        p = np.stack([_rand_dist(master, V) for _ in range(gamma + 1)])
        props = master.integers(0, V, gamma)
        if trial % 5 == 0:
            q[1, props[1]] = 0.0  # a zero-mass proposal rejects
        got = spec_verify(props, q, p, np.random.default_rng(trial))
        want = jspec_verify(props, q, p, np.random.default_rng(trial))
        assert got == want


@pytest.mark.parametrize("draft", ["weak", "perfect"])
def test_greedy_spec_engine_matches_jax_and_plain_greedy(models, draft):
    (jt, jd), (tt, td) = models
    gamma = 3 if draft == "weak" else 4
    prompts = _prompts(3, 0 if draft == "weak" else 1)
    jecfg = JEngineConfig(max_slots=2, max_seq_len=256, kv_dtype=jnp.float32,
                          prefill_buckets=(16, 32), attn_impl="ref")
    jcfg = jget_config("debug-tiny")
    want_jax = _run(JSpecEngine(jt, jcfg, jd if draft == "weak" else jt, jcfg, jecfg,
                                gamma=gamma), prompts)
    want_plain = _run(Engine(tt, CFG, ECFG, device="cpu"), prompts)
    spec = SpecEngine(tt, CFG, td if draft == "weak" else tt, CFG, ECFG, gamma=gamma,
                      device="cpu")
    got = _run(spec, prompts)
    assert got == want_plain
    assert got == want_jax
    if draft == "weak":
        assert any(a < gamma for a in spec.accepted_histogram)
    else:
        assert max(spec.accepted_histogram) == gamma


def test_sampled_top_k_1_reduces_to_greedy(models):
    _, (tt, td) = models
    prompts = _prompts(2, 2)
    want = _run(Engine(tt, CFG, ECFG, device="cpu"), prompts)
    spec = SpecEngine(tt, CFG, td, CFG, ECFG, gamma=3, temperature=0.7, top_k=1, device="cpu")
    assert _run(spec, prompts) == want


def test_sampled_runs_and_stays_in_the_vocabulary(models):
    _, (tt, td) = models
    spec = SpecEngine(tt, CFG, td, CFG, ECFG, gamma=3, temperature=0.9, top_k=8, seed=3,
                      device="cpu")
    for out in _run(spec, _prompts(2, 3), max_new=10):
        assert len(out) == 10 and all(0 <= t < CFG.vocab_size for t in out)


def test_eos_stops_mid_block(models):
    _, (tt, td) = models
    prompts = _prompts(1, 4)
    [full] = _run(Engine(tt, CFG, ECFG, device="cpu"), prompts)
    eos = full[5]
    want = full[: full.index(eos) + 1]
    spec = SpecEngine(tt, CFG, td, CFG, ECFG, gamma=3, eos_token_id=eos, device="cpu")
    [got] = _run(spec, prompts)
    assert got == want


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


def test_chained_rounds_and_the_graph_round_match_single_rounds(models):
    _, (tt, td) = models
    prompts = _prompts(3, 7)
    single = dataclasses.replace(ECFG, decode_burst=1)
    want = _run(SpecEngine(tt, CFG, td, CFG, single, gamma=3, device="cpu"), prompts, 14)
    burst = SpecEngine(tt, CFG, td, CFG, ECFG, gamma=3, device="cpu")
    assert burst._spec_rounds() == 1  # no active slot yet
    assert _run(burst, prompts, 14) == want
    assert burst.rounds_total >= 4
    body = BodyRounds(tt, CFG, td, CFG, ECFG, gamma=3, device="cpu")
    assert _run(body, prompts, 14) == want


def test_speculative_decoder_greedy_matches_plain_greedy(models):
    _, (tt, td) = models
    prompt = np.arange(1, 9, dtype=np.int32)
    [want] = _run(Engine(tt, CFG, ECFG, device="cpu"), [prompt], 16)
    dec = SpeculativeDecoder(tt, CFG, td, CFG, gamma=4, max_seq_len=256,
                             kv_dtype=torch.float32, device="cpu")
    assert dec.generate(prompt, 16) == want
    sampled = SpeculativeDecoder(tt, CFG, td, CFG, gamma=3, max_seq_len=256,
                                 kv_dtype=torch.float32, temperature=0.8, top_k=6, device="cpu")
    out = sampled.generate(prompt, 10)
    assert len(out) == 10 and all(0 <= t < CFG.vocab_size for t in out)


def _chi2_pvalue(counts, probs):
    return stats.chisquare(counts, counts.sum() * probs).pvalue


def test_on_device_acceptance_keeps_the_target_distribution():
    """Committed positions 0 and 1 follow p[0] and p[1] whatever the draft
    proposes (chi-square over 40,000 rows, each an independent round)."""
    V, g, B = 12, 3, 40_000
    master = np.random.default_rng(0)
    q = torch.from_numpy(np.stack([_rand_dist(master, V) for _ in range(g)])).float()
    p = torch.from_numpy(np.stack([_rand_dist(master, V) for _ in range(g + 1)])).float()
    gen = torch.Generator().manual_seed(1)
    qb = q[None].expand(B, g, V).contiguous()
    pb = p[None].expand(B, g + 1, V).contiguous()
    proposals = draw(qb, gen)
    # The draft's own draws follow q.
    assert _chi2_pvalue(np.bincount(proposals[:, 0].numpy(), minlength=V),
                        q[0].double().numpy()) > 1e-3
    n_acc, correction = leviathan_accept(proposals, qb, pb, gen)
    first = torch.where(n_acc > 0, proposals[:, 0], correction).numpy()
    assert _chi2_pvalue(np.bincount(first, minlength=V), p[0].double().numpy()) > 1e-3
    has_second = (n_acc >= 1).numpy()
    second = torch.where(n_acc > 1, proposals[:, 1], correction).numpy()[has_second]
    assert _chi2_pvalue(np.bincount(second, minlength=V), p[1].double().numpy()) > 1e-3
    # A draft equal to the target accepts everything.
    n_all, _ = leviathan_accept(draw(pb[:, :g], gen), pb[:, :g].contiguous(), pb, gen)
    assert bool((n_all == g).all())


def test_serve_cli_draft_model_runs_on_the_cpu():
    code = ("from llm_fp8_tpu_torch.cli.serve import main\n"
            "main(['--model_name', 'debug-tiny', '--random_init', '--precision', 'fp8', "
            "'--kv_dtype', 'fp8', '--device', 'cpu', '--draft_model', 'debug-tiny', "
            "'--gamma', '3', '--num_requests', '3', '--prompt_len', '10', "
            "'--max_new_tokens', '6', '--max_slots', '2', '--max_seq_len', '64'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["generated_tokens"] == 18
    assert out["spec_gamma"] == 3
    assert out["spec_tokens_per_round"] == pytest.approx(out["spec_mean_accepted"] + 1)


def test_spec_entry_points_default_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, (tt, td) = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpecEngine(tt, CFG, td, CFG, ECFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeculativeDecoder(tt, CFG, td, CFG)
