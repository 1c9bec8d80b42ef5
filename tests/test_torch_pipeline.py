"""The port's GPipe pipeline (``parallel/pipeline.py``) in a gloo world of 4
CPU processes (``tests/torch_dist_worker.py`` ``pipeline``, no JAX
imported), against the plain forward, as JAX's ``tests/test_pipeline.py``
holds its own.

``forward_pipelined`` on debug-small (4 layers) in float32 compute at pp 4
with 4 and 8 microbatches and at pp 2 (x dp 2) with 2: the logits and the
gradients of ``sum(logits · dlogits)`` (every stage's layers summed over
the stages; the embedding and final norm as every rank holds them) within
2e-4 of the plain forward's largest |value| (read: at most 1.3e-6) on
every rank. ``stage_params`` against JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.parallel.pipeline import stage_params as jax_stage_params
from llm_fp8_tpu_torch.convert import tree_to_numpy
from llm_fp8_tpu_torch.models import get_config
from llm_fp8_tpu_torch.models.llama import init_params
from llm_fp8_tpu_torch.parallel.pipeline import stage_params
from torch_dist_worker import launch_world

torch.set_num_threads(1)

MODEL = "debug-small"
TOL = 2e-4
RUNS = {"pp4_mb4": ({"fsdp": 1, "pp": 4}, 4), "pp4_mb8": ({"fsdp": 1, "pp": 4}, 8),
        "pp2_dp2_mb2": ({"dp": 2, "fsdp": 1, "pp": 2}, 2)}


@pytest.fixture(scope="module")
def pipeline_world(tmp_path_factory):
    cfg = get_config(MODEL)
    g = torch.Generator().manual_seed(0)
    inputs = dict(model=MODEL, runs=RUNS,
                  params=tree_to_numpy(init_params(cfg, dtype=torch.float32, device="cpu")),
                  tokens=torch.randint(0, cfg.vocab_size, (8, 32), generator=g),
                  dlogits=torch.randn(8, 32, cfg.vocab_size, generator=g) * 1e-2)
    return launch_world("pipeline", tmp_path_factory.mktemp("pipeline"), inputs)


@pytest.mark.parametrize("what", ["logits", "grads"])
@pytest.mark.parametrize("run", list(RUNS))
def test_pipelined_forward_matches_the_plain_forward(pipeline_world, run, what):
    plain = pipeline_world[0]["plain"]
    keys = ["logits"] if what == "logits" else [k for k in plain if k != "logits"]
    for rank, out in enumerate(pipeline_world):
        for k in keys:
            err = float((out[run][k] - plain[k]).abs().max() / plain[k].abs().max())
            assert err <= TOL, (run, rank, k, err)


def test_pipeline_ranks_import_no_jax(pipeline_world):
    assert all(o["jax_loaded"] == [] for o in pipeline_world)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_stage_params_matches_jax(n_stages):
    rng = np.random.default_rng(0)
    layers = {"wqkv": rng.standard_normal((4, 6, 10)).astype(np.float32),
              "norm_attn": rng.standard_normal((4, 6)).astype(np.float32)}
    want = jax_stage_params({k: jnp.asarray(v) for k, v in layers.items()}, n_stages)
    got = stage_params({k: torch.from_numpy(v) for k, v in layers.items()}, n_stages)
    for k in layers:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
