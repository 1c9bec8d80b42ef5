"""The port's ring attention (``parallel/ring_attention.py``) in gloo worlds
of CPU processes, held to JAX's golden attention and its ``jax.vjp``.

As JAX's own ring tests do, the reference is ``attention_ref`` over the
whole sequence, never JAX's ring (Pallas interpret mode under ``shard_map``
takes minutes). One world of 4 processes (``tests/torch_dist_worker.py``
``ring``, no JAX imported) runs every case in its ring of 4 and in two
rings of 2, in float32: causal and non-causal, a sliding window, a softcap
with ragged ``kv_lens``, and a non-causal window with ragged lengths (later
chunks at negative relative offsets, whole chunks dead). Outputs and the
gradients of ``sum(out · dout)`` are held within 1e-5 of the reference's
largest |value| (read: at most 8.4e-7). Three planted faults must move them
by more than 1e-2 of it: the relative offset with rank and source swapped,
no final hop of the dK/dV accumulators, and each chunk's own LSE in place
of the global one in the backward.

Without a world: the schedule and the chunk lengths against JAX's
``_chunk_schedule``/``_local_lens``, and ``chip_smoke.py``'s one-process
ring (every rank's steps through the same step functions, the hop a
rotation of a list) against the golden attention.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_fp8_tpu.parallel  # noqa: F401 (loads its ring_attention module)
from llm_fp8_tpu.ops.attention import attention_ref as jax_attention_ref
from torch_dist_worker import ROOT, launch_world

torch.set_num_threads(1)

# The package exports the function under the module's name.
JRA = sys.modules["llm_fp8_tpu.parallel.ring_attention"]
TOL = 1e-5
B, S, HQ, HK, D = 2, 64, 4, 2, 32
CASES = {
    "causal": dict(causal=True, window=None, softcap=None, kv_lens=None),
    "full": dict(causal=False, window=None, softcap=None, kv_lens=None),
    "window": dict(causal=True, window=24, softcap=None, kv_lens=None),
    "softcap_ragged": dict(causal=True, window=None, softcap=5.0, kv_lens=[64, 37]),
    "full_window_ragged": dict(causal=False, window=20, softcap=3.0, kv_lens=[50, 10]),
}
FAULTS = ("swapped_q_offset", "no_final_hop", "local_lse")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, c in CASES.items():
        arr = {x: rng.standard_normal(shape).astype(np.float32)
               for x, shape in (("q", (B, S, HQ, D)), ("k", (B, S, HK, D)), ("v", (B, S, HK, D)),
                                ("dout", (B, S, HQ, D)))}
        out[name] = dict(arr, **c)
    return out


def _jax_reference(c):
    lens = None if c["kv_lens"] is None else jnp.asarray(c["kv_lens"], jnp.int32)

    def f(q, k, v):
        return jax_attention_ref(q, k, v, causal=c["causal"], window=c["window"],
                                 softcap=c["softcap"], kv_lens=lens)

    out, vjp = jax.vjp(f, *(jnp.asarray(c[x]) for x in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(c["dout"]))
    return {k: np.asarray(v) for k, v in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    cases = _inputs()
    torch_cases = {name: {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                              torch.tensor(v, dtype=torch.int32) if k == "kv_lens" and v
                              else v) for k, v in c.items()} for name, c in cases.items()}
    outs = launch_world("ring", tmp_path_factory.mktemp("ring"), {"cases": torch_cases})
    refs = {name: _jax_reference(c) for name, c in cases.items()}
    return outs, refs


def _rel(got, ref):
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_ring_matches_jax_golden_and_its_vjp(ring_world, name, n):
    outs, refs = ring_world
    got = outs[0][(name, n)]
    for key in ("out", "dq", "dk", "dv"):
        assert _rel(got[key], refs[name][key]) <= TOL, (name, n, key, _rel(got[key],
                                                                           refs[name][key]))
    for r in range(1, 4):  # every rank gathered the same whole tensors
        assert all(torch.equal(outs[r][(name, n)][k], got[k]) for k in got)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_ring_faults_are_caught(ring_world, fault):
    outs, refs = ring_world
    got = outs[0][(fault, 4)]
    worst = max(_rel(got[k], refs["causal"][k]) for k in ("out", "dq", "dk", "dv"))
    assert worst > 1e-2, (fault, worst)


def test_ring_ranks_import_no_jax(ring_world):
    outs, _ = ring_world
    assert all(o["jax_loaded"] == [] for o in outs)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 40),
                                           (False, 20)])
def test_chunk_schedule_and_lengths_match_jax(causal, window):
    from llm_fp8_tpu_torch.parallel.ring_attention import RingSpec, chunk_schedule, step_args

    n, Sq, Sk = 4, 32, 32
    lens = jnp.asarray([100, 9], jnp.int32)
    spec = RingSpec(causal=causal, scale=1.0, window=window)
    for idx in range(n):
        for step in range(n):
            src, qo, dead = chunk_schedule(step, idx, Sq, Sk, n, causal, window)
            jsrc, jqo, jdead = JRA._chunk_schedule(step, idx, Sq, Sk, n, causal, window)
            assert (src, qo, dead) == (int(jsrc), int(jqo), bool(jdead))
            args = step_args(step, idx, n, (2, Sq), (2, Sk), torch.tensor([100, 9]), spec, "cpu")
            want = np.asarray(JRA._local_lens(lens, jsrc, Sk, jdead, 2))
            if dead:
                assert args is None and not want.any()
            else:
                assert args[0].tolist() == [qo, qo] and args[1].numpy().tolist() == want.tolist()


@pytest.mark.parametrize("name", ["causal", "full_window_ragged"])
def test_chip_smokes_one_process_ring_matches_the_golden(name):
    sys.path.insert(0, ROOT)
    import chip_smoke

    c = _inputs(1)[name]
    ref = _jax_reference(c)
    q, k, v, do = (torch.from_numpy(c[x]) for x in ("q", "k", "v", "dout"))
    lens = None if c["kv_lens"] is None else torch.tensor(c["kv_lens"], dtype=torch.int32)
    out, lse, dq, dk, dv = chip_smoke.ring_in_one_process(
        q, k, v, do, n=4, causal=c["causal"], window=c["window"], softcap=c["softcap"],
        kv_lens=lens, scale=D ** -0.5)
    for key, got in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert _rel(got, ref[key]) <= TOL, (key, _rel(got, ref[key]))
