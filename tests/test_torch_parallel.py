"""The port's distribution (``llm_fp8_tpu_torch/parallel``, ``Trainer(mesh=)``,
``cli.train`` under torchrun) against the JAX package and the port's own
single-process ``Trainer`` (which ``test_torch_training.py`` holds to JAX).

Without a world: ``MeshConfig.resolve``, and ``param_specs`` equal to JAX's
for every registry family at debug size (and a quantized tree) on meshes
(dp, fsdp, tp) = (2, 2, 2) and (1, 8, 1) (``conftest.py`` gives JAX 8 CPU
devices; the port's specs are pure functions of names, shapes and sizes),
with the batch, activation and KV-cache specs and ``adapt_spec``.

A gloo world of 4 CPU processes (``tests/torch_dist_worker.py`` ``train``,
no JAX imported) trains debug-small over three meshes, two steps of B 16 x
S 64 each (every rank passes the global batch and trains on its rows), at
the trainer's default learning rate (1e-5, no warmup); at 4 x 64 rows a
rank the CPU's float32 products give every row the bits of the whole
batch's (at 64 rows a K = 1024 product rounds otherwise):

* ``fsdp 4``, bf16 recipe; ``dp 2 x fsdp 2``, LAYERWISE on the native fp8
  route (K9's plain version takes dW's per-column gradient scales over the
  world's rows); the first step (identical weights): the loss within 1e-6
  relative (read: 0 and 6.2e-8), the gradient norm within 1e-5 (read
  4.4e-6, 2.8e-6), the fp8 dots' float32 weight gradients within 1e-6
  relative L2 (read 7.0e-8), the bf16 products' bf16 gradients, each rank's
  rounded before the sum, within 1e-2 (read 2.3e-3), and the
  delayed-scaling state bit for bit. The second step's loss within 1e-4
  (read: 3.2e-6, 1.6e-5) and the weights within 1e-3 (read 2.8e-5): the
  world's gradient is summed in another order, Adam turns the near-zero
  entries' rounding into updates of a whole learning rate, and bf16
  weights and e4m3 codes re-round where a float32 weight moved (the
  second step's delayed state reads 2.2e-2 off).
* ``fsdp 2 x cp 2``, bf16 recipe: attention rings over the sequence. On
  the CPU the ring's partials come from K3's plain version (P and each
  partial output in bf16) where the single-process path takes the float32
  golden attention, so the first loss reads 7.9e-6 (held to 5e-5), the
  gradient norm 4.2e-5 (held to 1e-3: a cp gradient summed over the ranks
  would read 1.0) and the gradients 7.9e-3 (held to 3e-2); every rank ends
  with the same parameters.
* Planted: the amaxes not all-reduced (dp 2 x fsdp 2) must break the
  delayed state's equality after the first step.
* A checkpoint saved under fsdp 2 x cp 2 restores under dp 2 x cp 2 (the
  gathered tensors equal, the next step's loss equal).

A world of one (gloo, in this process): the mesh path equals the mesh-less
``Trainer`` bit for bit (losses and parameters), as ``chip_smoke.py``'s
``dist_train`` checks on NCCL. ``cli.train`` under torchrun (2 processes,
``--device cpu``) with ``--fsdp 2`` and with ``--cp 2``; ``--tp 2`` and
``--ep 2`` still refused.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import registry as jreg
from llm_fp8_tpu.parallel import mesh as jmesh
from llm_fp8_tpu.parallel import sharding as jshard
from llm_fp8_tpu.quant import LAYERWISE as J_LAYERWISE
from llm_fp8_tpu.quant.qtensor import QTensor as JQTensor
from llm_fp8_tpu_torch.convert import params_from_numpy, tree_to_numpy
from llm_fp8_tpu_torch.models import get_config
from llm_fp8_tpu_torch.models import registry as preg
from llm_fp8_tpu_torch.models.llama import init_params
from llm_fp8_tpu_torch.parallel import MeshConfig, sharding as psharding
from llm_fp8_tpu_torch.quant import LAYERWISE, QTensor
from llm_fp8_tpu_torch.training import TrainConfig, Trainer
from llm_fp8_tpu_torch.training.trainer import _leaves
from torch_dist_worker import ROOT, free_port, launch_world

torch.set_num_threads(1)

MESHES = {"2x2x2": dict(dp=2, fsdp=2, tp=2), "1x8x1": dict(dp=1, fsdp=8, tp=1)}
DEBUG_NAMES = [n for n in preg.zoo_model_names() if n.startswith("debug-")]


# --------------------------------------------------------------------------
# Without a world
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,n", [(dict(), 8), (dict(dp=2), 8), (dict(dp=2, fsdp=2, tp=2), 8),
                                   (dict(cp=2, tp=2), 8), (dict(dp=1, fsdp=4), 4),
                                   (dict(pp=4, ep=2), 8), (dict(dp=3), 8),
                                   (dict(dp=2, fsdp=2), 8)])
def test_mesh_config_resolve_matches_jax(cfg, n):
    try:
        want = jmesh.MeshConfig(**cfg).resolve(n)
    except (AssertionError, ValueError) as e:
        with pytest.raises(type(e)):
            MeshConfig(**cfg).resolve(n)
        return
    got = MeshConfig(**cfg).resolve(n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _jax_specs(tree):
    """JAX's spec tree with PartitionSpecs as tuples and QTensors as dicts."""
    if isinstance(tree, dict):
        return {k: _jax_specs(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"qvalue": tuple(tree.qvalue), "scale": tuple(tree.scale)}
    return tuple(tree)


@pytest.fixture(scope="module")
def jax_meshes():
    return {name: jmesh.make_mesh(jmesh.MeshConfig(**c, pp=1, cp=1, ep=1), jax.devices()[:8])
            for name, c in MESHES.items()}


def _sizes(c):
    return {"dp": c["dp"], "fsdp": c["fsdp"], "pp": 1, "cp": 1, "ep": 1, "tp": c["tp"]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", DEBUG_NAMES)
def test_param_specs_match_jax_for_every_family(jax_meshes, name, mesh):
    jentry, pentry = jreg.resolve_model(name), preg.resolve_model(name)
    jshapes = jax.eval_shape(lambda: jentry.init_fn(jentry.cfg, jax.random.PRNGKey(0),
                                                    dtype=jnp.float32))
    params = pentry.init_fn(pentry.cfg, dtype=torch.float32, device="cpu", seed=0)
    want = _jax_specs(jshard.param_specs(jshapes, jax_meshes[mesh]))
    assert psharding.param_specs(params, _sizes(MESHES[mesh])) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_of_quantized_leaves_match_jax(jax_meshes, mesh, monkeypatch):
    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", "0")
    from llm_fp8_tpu.models import llama as jllama
    from llm_fp8_tpu_torch.models.llama import quantize_params

    cfg = get_config("debug-small")
    jshapes = jax.eval_shape(lambda: jllama.quantize_params(
        jllama.init_params(jreg.resolve_model("debug-small").cfg, jax.random.PRNGKey(0),
                           dtype=jnp.float32), J_LAYERWISE))
    params = quantize_params(init_params(cfg, dtype=torch.float32, device="cpu"), LAYERWISE)
    assert isinstance(params["layers"]["wqkv"], QTensor)
    want = _jax_specs(jshard.param_specs(jshapes, jax_meshes[mesh]))
    assert psharding.param_specs(params, _sizes(MESHES[mesh])) == want


def test_batch_activation_and_cache_specs_match_jax(jax_meshes):
    for ours, theirs in ((psharding.batch_spec(), jshard.batch_spec()),
                         (psharding.activation_spec(), jshard.activation_spec()),
                         (psharding.activation_spec(sp=True), jshard.activation_spec(sp=True)),
                         (psharding.kv_cache_spec(), jshard.kv_cache_spec())):
        assert ours == tuple(theirs)
    spec = jshard.kv_cache_spec()
    for shape in ((4, 8, 64, 2, 32), (4, 3, 64, 4, 32), (4, 1, 64, 1, 32)):
        want = tuple(jshard.adapt_spec(spec, shape, jax_meshes["2x2x2"]))
        assert psharding.adapt_spec(tuple(spec), shape, _sizes(MESHES["2x2x2"])) == want


# --------------------------------------------------------------------------
# A world of 4 (the trainer) against the single-process Trainer
# --------------------------------------------------------------------------

MODEL = "debug-small"
TRAIN_CFG = dict(warmup_steps=0, total_steps=10)
RUNS = {"fsdp4": dict(mesh={"fsdp": 4}, recipes="bf16", native="0"),
        "dp2_fsdp2_fp8": dict(mesh={"dp": 2, "fsdp": 2}, recipes="default", native="1"),
        "fsdp2_cp2": dict(mesh={"fsdp": 2, "cp": 2}, recipes="bf16", native="0"),
        "planted_no_amax_all_reduce": dict(mesh={"dp": 2, "fsdp": 2}, recipes="default",
                                           native="1", fault="no_amax_all_reduce")}


def _batches(n=3, B=16, S=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, get_config(MODEL).vocab_size, (B, S)).astype(np.int32)
        mask = np.ones((B, S), np.int32)
        mask[:, -3:] = 0
        mask[1, 10:] = 0
        out.append({"input_ids": ids, "attention_mask": mask})
    return out


def _qstate(qstate):
    return {f"{site}/{t}": torch.cat([s.history.flatten(), s.scale.flatten()])
            for site, st in qstate.items() for t, s in st.items()}


def _reference(params_np, batches, recipes, native):
    os.environ["LLM_FP8_NATIVE_DOT"] = native
    tr = Trainer(get_config(MODEL), TrainConfig(**TRAIN_CFG, recipes=recipes), device="cpu")
    state = tr.init_state(params_from_numpy(params_np, device="cpu"))
    grads = {p: g.clone() for p, g in tr.loss_and_grads(state, batches[0])[4].items()}
    metrics, qstates = [], []
    for b in batches[:2]:
        state, m = tr.train_step(state, b)
        metrics.append({k: v.item() for k, v in m.items()})
        qstates.append(_qstate(state.qstate))
    return dict(metrics=metrics, qstates=qstates, grads=grads,
                params={p: t.detach().clone() for p, t in _leaves(state.params)})


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("train")
    params = tree_to_numpy(init_params(get_config(MODEL), dtype=torch.float32, device="cpu",
                                       seed=0))
    batches = _batches()
    inputs = dict(model=MODEL, params=params, batches=batches, train_cfg=TRAIN_CFG, runs=RUNS,
                  ckpt_dir=str(work / "ckpt"))
    outs = launch_world("train", work, inputs)
    saved = os.environ.get("LLM_FP8_NATIVE_DOT")
    try:
        refs = {(r, n): _reference(params, batches, r, n) for r, n in
                {(run["recipes"], run["native"]) for run in RUNS.values()}}
    finally:
        if saved is None:
            os.environ.pop("LLM_FP8_NATIVE_DOT", None)
        else:
            os.environ["LLM_FP8_NATIVE_DOT"] = saved
    return outs, {name: refs[(run["recipes"], run["native"])] for name, run in RUNS.items()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


@pytest.mark.parametrize("name", ["fsdp4", "dp2_fsdp2_fp8"])
def test_world_first_step_matches_the_single_process_trainer(train_world, name):
    outs, refs = train_world
    got, ref = outs[0][name], refs[name]
    m, r = got["metrics"][0], ref["metrics"][0]
    assert _rel(m["loss"], r["loss"]) <= 1e-6, (m["loss"], r["loss"])
    assert m["tokens"] == r["tokens"] and m["finite"] == 1
    assert _rel(m["grad_norm"], r["grad_norm"]) <= 1e-5
    for p, g in ref["grads"].items():
        # bf16 products give bf16 weight gradients: each rank's rounded
        # before the sum; the fp8 dots' float32 dW are summed unrounded.
        tol = 1e-6 if name == "dp2_fsdp2_fp8" and p.startswith("layers/w") else 1e-2
        assert _rel_l2(got["grads"][p], g) <= tol, (p, _rel_l2(got["grads"][p], g))
    for key, q in ref["qstates"][0].items():  # step 1's observations: bit for bit
        assert torch.equal(got["qstates"][0][key], q), key


@pytest.mark.parametrize("name", ["fsdp4", "dp2_fsdp2_fp8", "fsdp2_cp2"])
def test_world_second_step_and_ranks_agree(train_world, name):
    outs, refs = train_world
    got, ref = outs[0][name], refs[name]
    assert _rel(got["metrics"][1]["loss"], ref["metrics"][1]["loss"]) <= 1e-4
    for p, t in ref["params"].items():
        assert _rel_l2(got["params"][p], t) <= 1e-3, p
    for r in range(1, 4):  # every rank: the same metrics and the same gathered weights
        assert outs[r][name]["metrics"] == got["metrics"]
        assert all(torch.equal(outs[r][name]["params"][p], got["params"][p])
                   for p in got["params"])


def test_cp_world_gradients_are_not_multiplied(train_world):
    outs, refs = train_world
    got, ref = outs[0]["fsdp2_cp2"], refs["fsdp2_cp2"]
    m, r = got["metrics"][0], ref["metrics"][0]
    assert _rel(m["loss"], r["loss"]) <= 5e-5, (m["loss"], r["loss"])
    assert _rel(m["grad_norm"], r["grad_norm"]) <= 1e-3, (m["grad_norm"], r["grad_norm"])
    for p, g in ref["grads"].items():
        assert _rel_l2(got["grads"][p], g) <= 3e-2, p


def test_planted_amax_fault_breaks_the_delayed_state(train_world):
    outs, refs = train_world
    got, ref = outs[0]["planted_no_amax_all_reduce"], refs["planted_no_amax_all_reduce"]
    assert not all(torch.equal(got["qstates"][0][k], q) for k, q in ref["qstates"][0].items())


def test_checkpoint_saved_under_fsdp_restores_under_dp(train_world):
    outs, _ = train_world
    ck = outs[0]["ckpt"]
    assert ck["equal"] and ck["step"] == 3 and ck["count"] == 3
    assert "Shard(dim=1)" not in ck["placements"].split(",")[0]  # dp replicates
    assert _rel(ck["loss_dp"], ck["loss_fsdp"]) <= 1e-6


def test_constrain_redistributes_to_the_batch_spec(train_world):
    outs, _ = train_world
    x = torch.arange(32.0).reshape(8, 4)
    for r, o in enumerate(outs):  # dp 2 x fsdp 2: rank r = 2·dp + fsdp holds rows 2r, 2r+1
        assert o["constrain"]["full_equal"]
        assert torch.equal(o["constrain"]["local"], x[2 * r:2 * r + 2])
        assert o["constrain"]["placements"][:2] == ["S(0)", "S(0)"]  # Shard(0) on dp, fsdp


def test_world_ranks_import_no_jax(train_world):
    outs, _ = train_world
    assert all(o["jax_loaded"] == [] for o in outs)


# --------------------------------------------------------------------------
# A world of one, and the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("recipes,native", [("bf16", "0"), ("default", "1")])
def test_world_of_one_equals_the_meshless_trainer_bit_for_bit(recipes, native, monkeypatch):
    import torch.distributed as dist

    from llm_fp8_tpu_torch.parallel import gather_tree, make_mesh, shard_params

    monkeypatch.setenv("LLM_FP8_NATIVE_DOT", native)
    cfg = get_config("debug-tiny")
    batches = [{k: v[:4, :32] for k, v in b.items()} for b in _batches(2, seed=1)]
    for b in batches:
        b["input_ids"] = b["input_ids"] % cfg.vocab_size
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh(MeshConfig(), "cpu")):
            tr = Trainer(cfg, TrainConfig(recipes=recipes, learning_rate=1e-3, warmup_steps=0),
                         device="cpu", mesh=mesh)
            params = init_params(cfg, dtype=torch.float32, device="cpu", seed=3)
            state = tr.init_state(shard_params(params, mesh) if mesh is not None else params)
            losses = [tr.train_step(state, b)[1]["loss"].item() for b in batches]
            runs.append((losses, dict(_leaves(gather_tree(state.params))), state.qstate))
    finally:
        dist.destroy_process_group()
    (l0, p0, q0), (l1, p1, q1) = runs
    assert l0 == l1
    assert all(torch.equal(p0[k].detach(), p1[k]) for k in p0)
    assert _qstate(q0).keys() == _qstate(q1).keys()
    assert all(torch.equal(a, _qstate(q1)[k]) for k, a in _qstate(q0).items())


def _torchrun(tmp_path, *flags):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(free_port()), "-m", "llm_fp8_tpu_torch.cli.train",
           "--model_name", "debug-tiny", "--random_init", "--synthetic_samples", "24",
           "--device", "cpu", "--batch_size", "4", "--max_seq_length", "32",
           "--num_epochs", "1", "--num_warmup_steps", "1", "--log_every", "2",
           "--log_dir", str(tmp_path / "runs"), "--output_dir", str(tmp_path / "out"),
           "--checkpoint_dir", str(tmp_path / "ckpt"), *flags]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("flags", [("--fsdp", "2", "--mixed_precision", "fp8"),
                                   ("--cp", "2", "--fsdp", "1")])
def test_train_cli_runs_under_torchrun(tmp_path, flags):
    res = _torchrun(tmp_path, *flags)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [json.loads(x) for x in res.stdout.splitlines() if x.startswith("{")]
    assert lines[0]["world"] == 2 and lines[0]["mesh"]["fsdp" if "--fsdp" == flags[0] else "cp"] == 2
    train = [x["train"] for x in lines if "train" in x]
    assert train and all(np.isfinite(t["loss"]) for t in train)
    assert lines[-1]["stability_report"]["non_finite_steps"] == 0
    assert {"model.safetensors", "config.json", "stability_report.json"} <= {
        p.name for p in (tmp_path / "out").iterdir()}
    assert any(p.name == "ckpt_best" for p in (tmp_path / "ckpt").iterdir())
    logged = (tmp_path / "runs" / "metrics.jsonl").read_text().splitlines()
    assert any('"eval/eval_loss"' in x for x in logged)  # rank 0 logs, once


@pytest.mark.parametrize("flag", ["--tp", "--ep"])
def test_train_cli_still_refuses_tp_and_ep(flag):
    from llm_fp8_tpu_torch.cli.train import main

    with pytest.raises(SystemExit, match="not ported yet: --tp/--ep above 1"):
        main(["--model_name", "debug-tiny", "--random_init", "--synthetic_samples", "8",
              "--device", "cpu", flag, "2"])
