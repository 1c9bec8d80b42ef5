"""Rank program of the port's distributed tests (imports torch and the port
only; never JAX): ``python tests/torch_dist_worker.py JOB RANK WORLD PORT DIR``,
and :func:`launch_world`, which the tests call to start a world of them.

Each rank joins a gloo world on ``localhost:PORT``, reads ``DIR/inputs.pt``
(written by the test), runs ``JOB`` and writes ``DIR/out_RANK.pt``; the
test holds the results to its references. Jobs:

* ``ring``: ``ring_attention`` in the world's ring of 4 and in two rings of
  2, forward and gradients of ``sum(out · dout)``, each case's full tensors
  gathered on every rank; then the planted faults in the ring of 4.
* ``train``: the ``Trainer`` over three meshes of 4 (fsdp 4, dp 2 x fsdp 2,
  fsdp 2 x cp 2), two steps each, the losses, metrics, delayed state and
  gathered parameters; a planted fault (the amaxes not all-reduced); a
  checkpoint saved under fsdp 2 x cp 2 restored under dp 2 x cp 2.
* ``pipeline``: ``forward_pipelined`` at pp 4 and pp 2 (x dp 2), logits and
  gradients, beside the plain forward on rank 0.
* ``serve``: ``Engine(mesh=)`` over the runs' meshes (tp 4, fsdp 2 x tp 2,
  dp 2 x tp 2), each rank's tokens, its tp and data coordinates and its
  int8 KV scales after every prefill (:class:`ScaleRecorder`); then
  ``SpecEngine(mesh=)`` over the spec runs' meshes (a run with ``spec``
  names its draft among ``inputs["drafts"]`` and its sampling), each rank's
  tokens, per-round accepted counts and the draft's layout.
"""
import faulthandler
import importlib
import os
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_world(job: str, workdir, inputs, world: int = 4, timeout: int = 300):
    """Run ``JOB`` of this file in a gloo world of ``world`` processes on
    ``inputs`` (from the test's process); returns every rank's output."""
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), str(port), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def _gather_seq(t, group):
    from llm_fp8_tpu_torch.parallel.collectives import _all_gather

    return _all_gather(t.detach(), 1, group)


def _ring_case(case, group):
    from llm_fp8_tpu_torch.parallel.collectives import group_rank, group_size
    from llm_fp8_tpu_torch.parallel.ring_attention import ring_attention

    n, r = group_size(group), group_rank(group)
    q, k, v, dout = (case[x].chunk(n, dim=1)[r].clone().requires_grad_(x != "dout")
                     for x in ("q", "k", "v", "dout"))
    out = ring_attention(q, k, v, group=group, causal=case["causal"], window=case["window"],
                         softcap=case["softcap"], kv_lens=case["kv_lens"])
    (out * dout).sum().backward()
    return {name: _gather_seq(t, group)
            for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}


def job_ring(inp, rank, world):
    # The package exports the function under the module's name.
    ra = importlib.import_module("llm_fp8_tpu_torch.parallel.ring_attention")

    full = dist.new_group(list(range(world)))
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    out = {}
    for name, case in inp["cases"].items():
        out[(name, 4)] = _ring_case(case, full)
        out[(name, 2)] = _ring_case(case, pair)

    # Planted faults, each in the ring of 4 on the first case.
    case = next(iter(inp["cases"].values()))
    real_schedule, real_bwd = ra.chunk_schedule, ra.bwd_partial

    def swapped(step, idx, Sq, Sk, n, causal, window):
        src, _, dead = real_schedule(step, idx, Sq, Sk, n, causal, window)
        return src, src * Sq - idx * Sk, dead

    def local_lse(q, k_blk, v_blk, o, lse, do, args, spec):
        _, lse_p = ra.fwd_partial(q, k_blk, v_blk, args, spec)
        return real_bwd(q, k_blk, v_blk, o, lse_p, do, args, spec)

    for fault, patch in (("swapped_q_offset", ("chunk_schedule", swapped)),
                         ("local_lse", ("bwd_partial", local_lse))):
        setattr(ra, *patch)
        try:
            out[(fault, 4)] = _ring_case(case, full)
        finally:
            ra.chunk_schedule, ra.bwd_partial = real_schedule, real_bwd
    out[("no_final_hop", 4)] = _ring_no_final_hop(case, full, ra)
    return out


def _ring_no_final_hop(case, group, ra):
    """The ring's backward without the last hop of the dK/dV accumulators:
    the exchange of the final [dk, dv] pair returns them where they are."""
    real = ra.exchange
    calls = {"n": 0}
    n = dist.get_world_size(group)

    def exchange(ts, grp, **kw):
        calls["n"] += 1
        # Forward: n - 1 exchanges; backward: n - 1 more, then the home hop.
        if calls["n"] == 2 * (n - 1) + 1:
            return list(ts)
        return real(ts, grp, **kw)

    ra.exchange = exchange
    try:
        return _ring_case(case, group)
    finally:
        ra.exchange = real


def _trainer_run(inp, mesh_cfg, recipes, native, steps, fault=None):
    from llm_fp8_tpu_torch.convert import params_from_numpy
    from llm_fp8_tpu_torch.models import get_config
    from llm_fp8_tpu_torch.parallel import MeshConfig, gather_tree, make_mesh, shard_params
    from llm_fp8_tpu_torch.parallel.fsdp import gather_param
    from llm_fp8_tpu_torch.training import TrainConfig, Trainer

    os.environ["LLM_FP8_NATIVE_DOT"] = native
    cfg = get_config(inp["model"])
    mesh = make_mesh(MeshConfig(**mesh_cfg), "cpu")
    trainer = Trainer(cfg, TrainConfig(**inp["train_cfg"], recipes=recipes), device="cpu",
                      mesh=mesh)
    if fault == "no_amax_all_reduce":
        trainer._reduce_amaxes = lambda amaxes, g_amaxes: None
    state = trainer.init_state(shard_params(params_from_numpy(inp["params"], device="cpu"),
                                            mesh))
    _, _, _, _, pgrads, _ = trainer.loss_and_grads(state, inp["batches"][0])
    with torch.no_grad():  # the world's gradients, whole
        grads = {p: gather_param(g, trainer.specs[p], mesh) for p, g in pgrads.items()}
    metrics, qstates = [], []
    for i in range(steps):
        state, m = trainer.train_step(state, inp["batches"][i])
        metrics.append({k: v.item() if torch.is_tensor(v) else v for k, v in m.items()})
        qstates.append(_plain_qstate(state.qstate))
    return trainer, state, {"metrics": metrics, "qstates": qstates, "grads": grads,
                            "params": _flat(gather_tree(state.params))}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _plain_qstate(qstate):
    return {f"{site}/{t}": torch.cat([s.history.flatten(), s.scale.flatten()])
            for site, st in qstate.items() for t, s in st.items()}


def job_train(inp, rank, world):
    from llm_fp8_tpu_torch.parallel import MeshConfig, make_mesh, shard_params
    from llm_fp8_tpu_torch.parallel.sharding import gather_tree
    from llm_fp8_tpu_torch.training import CheckpointManager, TrainConfig, Trainer
    from llm_fp8_tpu_torch.convert import params_from_numpy
    from llm_fp8_tpu_torch.models import get_config

    from llm_fp8_tpu_torch.parallel.sharding import batch_spec, constrain

    # constrain: a tensor every rank holds, redistributed to the batch spec.
    mesh = make_mesh(MeshConfig(dp=2, fsdp=2), "cpu")
    x = torch.arange(32.0).reshape(8, 4)
    c = constrain(x, mesh, batch_spec() + (None,))
    out = {"constrain": {"local": c.to_local().clone(), "full_equal": torch.equal(
        c.full_tensor(), x), "placements": [str(p) for p in c.placements]}}
    for name, run in inp["runs"].items():
        t0 = time.perf_counter()
        _, _, res = _trainer_run(inp, run["mesh"], run["recipes"], run["native"], 2,
                                 run.get("fault"))
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
    # Checkpoint: two steps under fsdp 2 x cp 2, saved; restored under dp 2 x cp 2.
    trainer, state, _ = _trainer_run(inp, {"fsdp": 2, "cp": 2}, "bf16", "0", 2)
    ckpt = CheckpointManager(inp["ckpt_dir"])
    ckpt.save(state, 2)
    saved = {k: v.clone() for k, v in _flat(gather_tree(state.params)).items()}
    mesh = make_mesh(MeshConfig(dp=2, fsdp=1, cp=2), "cpu")
    cfg = get_config(inp["model"])
    t2 = Trainer(cfg, TrainConfig(**inp["train_cfg"], recipes="bf16"), device="cpu", mesh=mesh)
    fresh = t2.init_state(shard_params(params_from_numpy(inp["params"], device="cpu"), mesh))
    restored = ckpt.restore(fresh)
    got = _flat(gather_tree(restored.params))
    equal = sorted(got) == sorted(saved) and all(torch.equal(got[k], saved[k]) for k in saved)
    _, m_a = trainer.train_step(state, inp["batches"][2])
    _, m_b = t2.train_step(restored, inp["batches"][2])
    out["ckpt"] = {"equal": equal,
                   "placements": str(restored.params["layers"]["wqkv"].placements),
                   "step": restored.step, "count": restored.opt_state.count,
                   "loss_fsdp": m_a["loss"].item(), "loss_dp": m_b["loss"].item()}
    return out


def job_pipeline(inp, rank, world):
    from llm_fp8_tpu_torch.convert import params_from_numpy
    from llm_fp8_tpu_torch.models import get_config
    from llm_fp8_tpu_torch.models.llama import forward
    from llm_fp8_tpu_torch.parallel import MeshConfig, make_mesh
    from llm_fp8_tpu_torch.parallel.pipeline import forward_pipelined

    cfg = get_config(inp["model"])
    tokens = inp["tokens"]
    out = {}

    def run(fn):
        params = params_from_numpy(inp["params"], device="cpu")
        leaves = [params["embed"], params["final_norm"], *params["layers"].values()]
        for t in leaves:
            t.requires_grad_(True)
        logits = fn(params)
        (logits * inp["dlogits"]).sum().backward()
        return {"logits": logits.detach(), "embed": params["embed"].grad,
                "final_norm": params["final_norm"].grad,
                **{k: v.grad for k, v in params["layers"].items()}}

    for name, (mesh_cfg, mb) in inp["runs"].items():
        mesh = make_mesh(MeshConfig(**mesh_cfg), "cpu")
        res = run(lambda p: forward_pipelined(p, tokens, cfg, mesh=mesh, n_microbatches=mb,
                                              compute_dtype=torch.float32))
        # Each stage's layers got their gradients on their rank: sum over pp.
        pp = mesh.get_group("pp")
        for k in inp["params"]["layers"]:
            dist.all_reduce(res[k], group=pp)
        out[name] = res
    if rank == 0:
        out["plain"] = run(lambda p: forward(p, tokens, cfg, compute_dtype=torch.float32)[0])
    return out


def scale_recorder():
    """The engine class the ``serve`` job runs (and its test, without a
    mesh): an ``Engine`` that keeps its int8 KV scales and recalibration
    count after every prefill."""
    from llm_fp8_tpu_torch.serving import Engine

    class ScaleRecorder(Engine):
        def _run_prefill(self, padded, true_len, slot):
            last = super()._run_prefill(padded, true_len, slot)
            self.scale_log.append((self._kscales.clone(), self._vscales.clone(),
                                   self.kv_recalibrations))
            return last

        def __init__(self, *args, **kw):
            self.scale_log = []
            super().__init__(*args, **kw)

    return ScaleRecorder


def serve_engine(run, params, cfg, drafts, mesh=None):
    """The engine of a ``serve`` run (and of its test's mesh-less
    reference): a ``SpecEngine`` over the run's draft (``drafts``: name →
    (config, tree)) where the run has ``spec``, else a
    :func:`scale_recorder` engine."""
    from llm_fp8_tpu_torch.parallel import shard_params
    from llm_fp8_tpu_torch.serving import EngineConfig, SpecEngine

    ecfg = EngineConfig(**run["ecfg"])
    if "spec" not in run:
        return scale_recorder()(params, cfg, ecfg, device="cpu", mesh=mesh)
    spec = dict(run["spec"])
    dcfg, dparams = drafts[spec.pop("draft")]
    if mesh is not None and run["sharded"]:
        dparams = shard_params(dparams, mesh)
    return SpecEngine(params, cfg, dparams, dcfg, ecfg, device="cpu", mesh=mesh, **spec)


def serve_result(eng, reqs, dcfg=None):
    """What a ``serve`` run reports of ``eng`` after its requests (``dcfg``:
    the whole draft's config, for a ``SpecEngine``)."""
    out = {"tokens": [r.output for r in reqs], "drift": eng.kv_drift_stats()}
    if dcfg is not None:
        out.update(accepted=list(eng.accepted_histogram), draft_split=eng.dtp is not None,
                   draft_cache=tuple(eng.dcache.k.shape),
                   draft_whole=eng.dparams["layers"]["wqkv"].shape[-1] == dcfg.qkv_dim)
    else:
        out["scale_log"] = eng.scale_log
    return out


def job_serve(inp, rank, world):
    import numpy as np

    from llm_fp8_tpu_torch.convert import params_from_numpy
    from llm_fp8_tpu_torch.models import get_config
    from llm_fp8_tpu_torch.parallel import MeshConfig, make_mesh, shard_params
    from llm_fp8_tpu_torch.serving import SamplingParams

    cfg = get_config(inp["model"])
    params = params_from_numpy(inp["params"], device="cpu")
    drafts = {name: (dcfg, params_from_numpy(tree, device="cpu"))
              for name, (dcfg, tree) in inp.get("drafts", {}).items()}
    out = {}
    for name, run in inp["runs"].items():
        t0 = time.perf_counter()
        mesh = make_mesh(MeshConfig(**run["mesh"]), "cpu")
        tree = shard_params(params, mesh) if run["sharded"] else params
        eng = serve_engine(run, tree, cfg, drafts, mesh)
        reqs = [eng.add_request(np.asarray(p, np.int32), SamplingParams(**sp))
                for p, sp in run["requests"]]
        eng.run()
        dcfg = drafts[run["spec"]["draft"]][0] if "spec" in run else None
        out[name] = dict(serve_result(eng, reqs, dcfg), tp_rank=eng.tp.rank, heads=eng._heads,
                         data_index=eng._data_index, slots=eng._nslots,
                         seconds=time.perf_counter() - t0)
    return out


def main():
    torch.set_num_threads(1)
    job, rank, world, port, workdir = sys.argv[1], *map(int, sys.argv[2:5]), sys.argv[5]
    # A rank stuck in a collective prints where and exits, so the test fails.
    faulthandler.dump_traceback_later(int(os.environ.get("TORCH_DIST_WORKER_TIMEOUT", 240)),
                                      exit=True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {"ring": job_ring, "train": job_train, "pipeline": job_pipeline,
           "serve": job_serve}[job](inp, rank, world)
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "llm_fp8_tpu"))
    torch.save(out, os.path.join(workdir, f"out_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
