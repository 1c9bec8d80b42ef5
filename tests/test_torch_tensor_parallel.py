"""Tensor-parallel serving in the port (``parallel/tensor.py``, the ``tp``
forward of ``models/llama.py``, ``quant/dot.py::k_split_over``,
``Engine(mesh=)``) against the mesh-less port and the JAX package.

Without a world:

* ``tp_rank_params`` partitions the tree: the ranks' q/k/v heads, gate and
  up halves, vocabulary rows, codes, scales (per channel, MX and int4
  groups) and biases reassemble the whole tree exactly; a row-parallel
  shard quantized on its own differs from the cut of the whole.
* The ranks of a tp group run as threads of this process
  (``local_tp_ranks``, the composition ``chip_smoke.py`` runs on the card):
  their forward equals the mesh-less forward in float32 within 1e-5
  relative (read: 1e-7 to 8e-7), with fp8 weights on the fp8native route
  too; each rank's K9 codes of a row-parallel input are the single
  process's codes' slice bit for bit. Indivisible heads (debug-tiny at tp
  4) replicate the attention; debug-qwen3's QK-norm runs on a rank's heads
  as on all; debug-baichuan's ALiBi slopes are the ranks' slices of the
  whole model's.
* Planted faults break the composition: ``wqkv`` cut contiguously, the
  row-parallel amax left local, ALiBi slopes rebuilt per rank.

A gloo world of 4 CPU processes (``tests/torch_dist_worker.py`` ``serve``,
one launch) serves debug-small (float32 weights, JAX's initializer) over tp
4, fsdp 2 x tp 2 and dp 2 x tp 2: four greedy requests give the mesh-less
port engine's tokens, which are JAX's greedy reference (``attn_impl="ref"``,
as ``tests/test_serving.py`` computes it); a sampled request gives the same
tokens on every rank of the tp group; int8 KV over dp 2 x tp 2: every
rank's scales after each prefill (the calibration and a recalibration
among them) are the mesh-less engine's slice. A world of one in this
process: tokens and every step's logits bit for bit against the mesh-less
engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_fp8_tpu.models import config as jconfig
from llm_fp8_tpu.models import llama as jllama
from llm_fp8_tpu.ops.sampling import greedy as jgreedy
from llm_fp8_tpu_torch.convert import params_from_numpy
from llm_fp8_tpu_torch.models import get_config
from llm_fp8_tpu_torch.models import llama as tllama
from llm_fp8_tpu_torch.models.llama import forward, init_params, quantize_params
from llm_fp8_tpu_torch.parallel import tensor as ptensor
from llm_fp8_tpu_torch.parallel import collectives as pcoll
from llm_fp8_tpu_torch.parallel.collectives import LocalGroup
from llm_fp8_tpu_torch.quant import INT4_WEIGHTS, LAYERWISE, MXFP8_SET, QTensor
from llm_fp8_tpu_torch.quant import dot as qdotmod
from llm_fp8_tpu_torch.quant.formats import E4M3
from llm_fp8_tpu_torch.quant.qtensor import quantize
from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams
from torch_dist_worker import free_port, launch_world, scale_recorder

torch.set_num_threads(1)

REL = 1e-5


def _tokens(cfg, B=2, S=24, seed=0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randint(1, cfg.vocab_size, (B, S)), dtype=torch.int32)


def _compose(params, cfg, size, tokens, **kw):
    """Every rank's forward over its shard, ranks as threads; rank 0's
    logits (every rank's are checked equal)."""
    ranks = ptensor.local_tp_ranks(params, cfg, size)
    outs = ranks[0][2].group.run(lambda r: forward(
        ranks[r][0], tokens, ranks[r][1], compute_dtype=torch.float32, tp=ranks[r][2],
        **kw)[0])
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    return outs[0], ranks[0][2].layout


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _codes(t):
    """A leaf's logical codes (QTensor: unpacked, unpadded) or values."""
    return t.unpack().contiguous() if isinstance(t, QTensor) else t


def _heads(t, cfg, n, r):
    """Rank r's q, k and v column blocks of the whole ``[..., q|k|v]``."""
    q, k, v = torch.split(t, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    return [x.chunk(n, dim=-1)[r] for x in (q, k, v)]


# --------------------------------------------------------------------------
# The shards
# --------------------------------------------------------------------------

TREES = {
    "debug-small f32 tp2": ("debug-small", None, 2, False),
    "debug-small f32 qkv bias tp4": ("debug-small", None, 4, True),
    "debug-small layerwise fp8native tp4": ("debug-small", LAYERWISE, 4, True),
    "debug-small mxfp8 tp2": ("debug-small", MXFP8_SET, 2, False),
    "debug-small int4 groups tp2": ("debug-small", INT4_WEIGHTS, 2, False),
    "debug-tiny layerwise tp4 (heads replicated)": ("debug-tiny", LAYERWISE, 4, False),
}


def _tree(model, recipes, bias, monkeypatch):
    cfg = get_config(model)
    if bias:
        cfg = dataclasses.replace(cfg, qkv_bias=True)
    params = init_params(cfg, dtype=torch.float32, device="cpu", seed=3)
    if bias:
        params["layers"]["bqkv"] = torch.randn(params["layers"]["bqkv"].shape)
    if recipes is not None:
        monkeypatch.setenv("LLM_FP8_QDOT", "fp8native")
        params = quantize_params(params, recipes)
    return cfg, params


@pytest.mark.parametrize("case", list(TREES))
def test_rank_params_reassemble_the_whole_tree(case, monkeypatch):
    model, recipes, n, bias = TREES[case]
    cfg, params = _tree(model, recipes, bias, monkeypatch)
    layout = ptensor.tp_layout(params, cfg, n)
    shards = [ptensor.tp_rank_params(params, cfg, r, n) for r in range(n)]
    whole = params["layers"]
    cat = lambda xs, d: torch.cat(xs, dim=d)  # noqa: E731
    for name in ("wqkv", "bqkv", "wo", "w_gate_up", "w_down"):
        if name not in whole:
            continue
        w, parts = whole[name], [s["layers"][name] for s in shards]
        split = layout.heads if name in ("wqkv", "bqkv", "wo") else layout.mlp
        fields = [("codes", _codes)] + ([("scale", lambda t: t.scale)]
                                        if isinstance(w, QTensor) else [])
        for field, get in fields:
            full, got = get(w), [get(p) for p in parts]
            if not split:
                assert all(torch.equal(g, full) for g in got), (name, field)
                continue
            if name in ("wqkv", "bqkv"):
                if field == "scale" and full.shape[-1] == 1:
                    assert all(torch.equal(g, full) for g in got)
                    continue
                local = dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                                            num_kv_heads=cfg.num_kv_heads // n)
                mine = [_heads(g, local, 1, 0) for g in got]
                for i, part in enumerate(zip(*mine)):
                    assert torch.equal(cat(part, -1), _heads(full, cfg, 1, 0)[i]), (name, i)
            elif name == "w_gate_up":
                if field == "scale" and full.shape[-1] == 1:
                    assert all(torch.equal(g, full) for g in got)
                    continue
                halves = [g.chunk(2, dim=-1) for g in got]
                assert torch.equal(cat([h[0] for h in halves] + [h[1] for h in halves], -1),
                                   full), (name, field)
            else:  # row-parallel: K's rows; per-channel scales whole, blocks cut
                if field == "scale" and (w.block_size is None):
                    assert all(torch.equal(g, full) for g in got)
                else:
                    assert torch.equal(cat(got, -2), full), (name, field)
        if isinstance(w, QTensor) and isinstance(parts[0], QTensor) and split:
            for p in parts:  # each shard its own contiguous storage
                assert p.qvalue.untyped_storage().nbytes() < w.qvalue.untyped_storage().nbytes()
    if layout.vocab:
        assert torch.equal(cat([s["embed"] for s in shards], 0), params["embed"])
        if "lm_head" in params:
            assert torch.equal(cat([_codes(s["lm_head"]) for s in shards], -1),
                               _codes(params["lm_head"]))
    for s in shards:
        assert torch.equal(s["final_norm"], params["final_norm"])
        assert torch.equal(s["layers"]["norm_attn"], whole["norm_attn"])


def test_row_parallel_shard_quantized_alone_differs_from_the_cut():
    cfg = get_config("debug-small")
    params = init_params(cfg, dtype=torch.float32, device="cpu", seed=3)
    q = quantize_params(params, LAYERWISE)
    cut = ptensor.tp_rank_params(q, cfg, 1, 4)["layers"]["w_down"]
    n = cfg.intermediate_size // 4
    alone = quantize(params["layers"]["w_down"][:, n:2 * n].float(), E4M3, axes=(1,),
                     flush_subnormal=True)
    assert torch.equal(cut.scale, q["layers"]["w_down"].scale)  # the whole K's amax
    assert not torch.equal(alone.scale, cut.scale)
    assert not torch.equal(alone.qvalue, cut.unpack().contiguous())


# --------------------------------------------------------------------------
# The composition
# --------------------------------------------------------------------------

COMPOSITIONS = {
    "debug-small f32 tp2": ("debug-small", None, 2),
    "debug-small f32 tp4": ("debug-small", None, 4),
    "debug-small fp8native tp4": ("debug-small", LAYERWISE, 4),
    "debug-small mxfp8 tp2": ("debug-small", MXFP8_SET, 2),
    "debug-qwen3 qk-norm tp2": ("debug-qwen3", None, 2),
    "debug-tiny f32 tp4 (heads replicated)": ("debug-tiny", None, 4),
    "debug-baichuan alibi tp2": ("debug-baichuan", None, 2),
    "debug-baichuan alibi tp4": ("debug-baichuan", None, 4),
}


@pytest.mark.parametrize("case", list(COMPOSITIONS))
def test_composed_ranks_equal_the_meshless_forward(case, monkeypatch):
    model, recipes, n = COMPOSITIONS[case]
    cfg, params = _tree(model, recipes, False, monkeypatch)
    toks = _tokens(cfg)
    ref, _ = forward(params, toks, cfg, compute_dtype=torch.float32)
    got, layout = _compose(params, cfg, n, toks)
    assert _rel(got, ref) <= REL, _rel(got, ref)
    if model == "debug-tiny":
        assert not layout.heads and layout.mlp and layout.vocab
    else:
        assert layout.heads and layout.mlp and layout.vocab


def test_composed_cache_path_equals_the_meshless_cache_path(monkeypatch):
    """Prefill into a KVCache and a decode step, float32, tp 4."""
    cfg, params = _tree("debug-small", None, False, monkeypatch)
    toks = _tokens(cfg, S=16)
    nxt = _tokens(cfg, S=1, seed=1)
    lens = torch.tensor([16, 11], dtype=torch.int32)

    def run(p, c, tp=None):
        cache = tllama.init_kv_cache(c, 2, 32, dtype=torch.float32, device="cpu")
        kw = {} if tp is None else {"tp": tp}
        a, cache = forward(p, toks, c, cache=cache, start_pos=0, kv_lens=lens,
                           compute_dtype=torch.float32, **kw)
        b, _ = forward(p, nxt, c, cache=cache, start_pos=lens, kv_lens=lens + 1,
                       compute_dtype=torch.float32, **kw)
        return torch.cat([a[:, -1], b[:, 0]])

    ref = run(params, cfg)
    ranks = ptensor.local_tp_ranks(params, cfg, 4)
    got = ranks[0][2].group.run(lambda r: run(*ranks[r]))
    assert _rel(got[0], ref) <= REL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [2, 4])
def test_k9_row_codes_are_the_single_process_slice(n, dtype):
    g = torch.Generator().manual_seed(7)
    x = (torch.randn((24, 512), generator=g) * torch.rand((24, 512), generator=g) * 3).to(dtype)
    x[3, 400] = 40.0  # one rank holds a row's largest value
    whole = qdotmod._quantize_channel(x, E4M3, 1, margin=0)
    group = LocalGroup(n)
    parts = group.run(lambda r: qdotmod._quantize_channel(x.chunk(n, dim=1)[r], E4M3, 1,
                                                          margin=0, k=group))
    got = torch.cat([p.qvalue for p in parts], dim=1)
    assert torch.equal(got.view(torch.uint8), whole.qvalue.view(torch.uint8))
    assert all(torch.equal(p.scale, whole.scale) for p in parts)
    local = group.run(lambda r: qdotmod._quantize_channel(x.chunk(n, dim=1)[r], E4M3, 1,
                                                          margin=0))
    assert not torch.equal(torch.cat([p.qvalue for p in local], dim=1).view(torch.uint8),
                           whole.qvalue.view(torch.uint8))


def test_composed_fp8native_forward_takes_the_single_process_k9_codes(monkeypatch):
    """Every K9 call of the tp 4 composition at the first layer's
    row-parallel products (wo, w_down) gives the slice of the mesh-less
    call's codes."""
    import llm_fp8_tpu_torch.kernels.quantize as kq

    cfg, params = _tree("debug-small", LAYERWISE, False, monkeypatch)
    cfg1 = dataclasses.replace(cfg, num_layers=1)
    params = dict(params, layers={
        k: (dataclasses.replace(v, qvalue=v.qvalue[:1], scale=v.scale[:1])
            if isinstance(v, QTensor) else v[:1]) for k, v in params["layers"].items()})
    toks = _tokens(cfg1)
    calls = {}
    real = kq.quantize_fused

    def spy(x, fmt, **kw):
        q = real(x, fmt, **kw)
        calls.setdefault(getattr(spy_rank, "r", "whole"), []).append(q.qvalue)
        return q

    import threading

    spy_rank = threading.local()
    monkeypatch.setattr(kq, "quantize_fused", spy)
    forward(params, toks, cfg1, compute_dtype=torch.float32)
    ranks = ptensor.local_tp_ranks(params, cfg1, 4)

    def rank_fwd(r):
        spy_rank.r = r
        return forward(ranks[r][0], toks, ranks[r][1], compute_dtype=torch.float32,
                       tp=ranks[r][2])[0]

    ranks[0][2].group.run(rank_fwd)
    whole = calls["whole"]  # qkv, wo, gate|up, down
    assert len(whole) == 4 and all(len(calls[r]) == 4 for r in range(4))
    for site in (1, 3):  # wo and w_down: the rank's K slice plus the amax columns
        got = torch.cat([calls[r][site][:, :whole[site].shape[1] // 4] for r in range(4)], 1)
        assert torch.equal(got.view(torch.uint8), whole[site].view(torch.uint8)), site
    for site in (0, 2):  # column-parallel inputs: the whole row on every rank
        assert all(torch.equal(calls[r][site].view(torch.uint8),
                                whole[site].view(torch.uint8)) for r in range(4))


# --------------------------------------------------------------------------
# Planted faults
# --------------------------------------------------------------------------


def _contiguous_qkv(cfg, rank, size, device=None):
    n = cfg.qkv_dim // size
    return torch.arange(rank * n, (rank + 1) * n, device=device)


def _local_amax(t, group):
    return t.clone()


def _alibi_per_rank(cfg, device, tp=None):
    from llm_fp8_tpu_torch.ops.attention import default_alibi_slopes

    return default_alibi_slopes(cfg.num_heads, device) if cfg.alibi else None


FAULTS = {
    "wqkv cut contiguously": ("debug-small", None, (ptensor, "qkv_columns", _contiguous_qkv)),
    "row-parallel amax left local": ("debug-small", LAYERWISE,
                                     (pcoll, "all_reduce_max", _local_amax)),
    "alibi slopes rebuilt per rank": ("debug-baichuan", None, (tllama, "_rank_alibi",
                                                               _alibi_per_rank)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_break_the_composition(fault, monkeypatch):
    model, recipes, (module, attr, fn) = FAULTS[fault]
    cfg, params = _tree(model, recipes, False, monkeypatch)
    toks = _tokens(cfg)
    ref, _ = forward(params, toks, cfg, compute_dtype=torch.float32)
    sound, _ = _compose(params, cfg, 4, toks)
    monkeypatch.setattr(module, attr, fn)
    bad, _ = _compose(params, cfg, 4, toks)
    assert _rel(sound, ref) <= REL
    rows = ((bad - ref).abs().amax(-1) > REL * ref.abs().max()).float().mean()
    assert rows > 0.9, (fault, float(rows))


# --------------------------------------------------------------------------
# A world of 4 processes, and a world of one
# --------------------------------------------------------------------------

MODEL = "debug-small"
ECFG = dict(max_slots=4, max_seq_len=128, kv_dtype=torch.float32, prefill_buckets=(16, 32))
GREEDY = dict(max_new_tokens=6)
SAMPLED = dict(max_new_tokens=6, temperature=0.8, top_k=20)
INT8 = dict(max_slots=4, max_seq_len=128, kv_dtype="int8", prefill_buckets=(16, 32),
            kv_recalibrate=True, kv_sat_threshold=1e-4)


def _prompts(cfg):
    rng = np.random.RandomState(3)
    return [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (7, 9, 11, 8)]


def _int8_prompts(cfg):
    """A short first prompt calibrates; longer ones then saturate it."""
    rng = np.random.RandomState(5)
    return [rng.randint(1, cfg.vocab_size, n).astype(np.int32) for n in (2, 30, 29, 31)]


def _runs(cfg):
    greedy = [(p, GREEDY) for p in _prompts(cfg)]
    return {
        "tp4": dict(mesh=dict(tp=4), sharded=False, ecfg=ECFG,
                    requests=greedy + [(_prompts(cfg)[1], SAMPLED)]),
        "fsdp2_tp2": dict(mesh=dict(fsdp=2, tp=2), sharded=True, ecfg=ECFG, requests=greedy),
        "dp2_tp2": dict(mesh=dict(dp=2, fsdp=1, tp=2), sharded=False, ecfg=ECFG,
                        requests=greedy),
        "int8_dp2_tp2": dict(mesh=dict(dp=2, fsdp=1, tp=2), sharded=False, ecfg=INT8,
                             requests=[(p, GREEDY) for p in _int8_prompts(cfg)]),
    }


def _jax_greedy(jparams, jcfg, prompts, new):
    """JAX's greedy decode of the prompts (``tests/test_serving.py``'s loop,
    the prompts right-padded into one batch, each at its own position)."""
    B, n = len(prompts), np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((B, n.max()), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    cache = jllama.init_kv_cache(jcfg, B, 128, dtype=jnp.float32)
    logits, cache = jllama.forward(jparams, jnp.asarray(toks), jcfg, cache=cache, start_pos=0,
                                   kv_lens=jnp.asarray(n), attn_impl="ref")
    out = [np.asarray(jgreedy(logits[jnp.arange(B), n - 1]))]
    for step in range(new - 1):
        pos = jnp.asarray(n + step)
        logits, cache = jllama.forward(jparams, jnp.asarray(out[-1])[:, None], jcfg,
                                       cache=cache, start_pos=pos, kv_lens=pos + 1,
                                       attn_impl="ref")
        out.append(np.asarray(jgreedy(logits[:, 0])))
    return np.stack(out, axis=1).tolist()


def _meshless(np_params, cfg, run):
    eng = scale_recorder()(params_from_numpy(np_params), cfg, EngineConfig(**run["ecfg"]),
                           device="cpu")
    reqs = [eng.add_request(p, SamplingParams(**sp)) for p, sp in run["requests"]]
    eng.run()
    return {"tokens": [r.output for r in reqs], "scale_log": eng.scale_log,
            "drift": eng.kv_drift_stats()}


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    jcfg = jconfig.get_config(MODEL)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(12), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = get_config(MODEL)
    runs = _runs(cfg)
    outs = launch_world("serve", work, dict(model=MODEL, params=np_params, runs=runs))
    refs = {name: _meshless(np_params, cfg, run) for name, run in runs.items()}
    jax_tokens = _jax_greedy(jparams, jcfg, _prompts(cfg), GREEDY["max_new_tokens"])
    return outs, refs, jax_tokens


@pytest.mark.parametrize("name", ["tp4", "fsdp2_tp2", "dp2_tp2"])
def test_world_greedy_tokens_are_the_meshless_engines_and_jaxs(serve_world, name):
    outs, refs, jax_tokens = serve_world
    assert refs[name]["tokens"][:4] == jax_tokens
    for o in outs:
        assert o[name]["tokens"][:4] == jax_tokens


def test_world_sampled_request_is_one_on_every_rank_of_the_tp_group(serve_world):
    outs, _, _ = serve_world
    sampled = [o["tp4"]["tokens"][4] for o in outs]
    assert len(sampled[0]) == SAMPLED["max_new_tokens"]
    assert all(s == sampled[0] for s in sampled)


def test_world_int8_kv_scales_are_the_meshless_engines_slices(serve_world):
    """Every rank's scales after each prefill: the calibration (a 2-token
    prompt, whose K/V come from the first products alone) the mesh-less
    engine's slice bit for bit, and so the ranks holding the same heads in
    both data groups after every prefill; each recalibration's within one
    bf16 ulp of the amax that sets it (2^-7 relative: the ranks' residual
    stream sums float32 partials in another order than one product, and a
    bf16 rounding can flip; read: 0 or 6.5e-3), on the same prefills."""
    outs, refs, _ = serve_world
    ref = refs["int8_dp2_tp2"]
    assert ref["scale_log"][-1][2] >= 2  # recalibrations happened
    by_heads = {}
    for o in outs:
        got = o["int8_dp2_tp2"]
        h0, h1 = got["heads"]
        assert len(got["scale_log"]) == len(ref["scale_log"])
        for i, ((gk, gv, gn), (rk, rv, rn)) in enumerate(zip(got["scale_log"],
                                                              ref["scale_log"])):
            assert gn == rn, i
            for g, r in ((gk, rk[h0:h1]), (gv, rv[h0:h1])):
                if i == 0:
                    assert torch.equal(g, r)
                assert float(((g - r) / r).abs().max()) <= 2.0 ** -7, (i, g, r)
        seen = by_heads.setdefault((h0, h1), got["scale_log"])
        assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(seen, got["scale_log"]))
        assert got["drift"]["recalibrations"] == ref["drift"]["recalibrations"]
        assert got["drift"]["warning"] == ref["drift"]["warning"]
        assert got["tokens"] == ref["tokens"]
    assert len(by_heads) == 2


def test_world_layout_of_slots_and_heads(serve_world):
    outs, _, _ = serve_world
    for rank, o in enumerate(outs):
        assert (o["tp4"]["tp_rank"], o["tp4"]["slots"]) == (rank, 4)
        assert o["dp2_tp2"]["tp_rank"] == rank % 2
        assert (o["dp2_tp2"]["data_index"], o["dp2_tp2"]["slots"]) == (rank // 2, 2)
        assert o["dp2_tp2"]["heads"] == (2 * (rank % 2), 2 * (rank % 2) + 2)
        assert (o["fsdp2_tp2"]["data_index"], o["fsdp2_tp2"]["slots"]) == (rank // 2, 2)


def test_world_ranks_import_no_jax(serve_world):
    outs, _, _ = serve_world
    assert all(o["jax_loaded"] == [] for o in outs)


class _LogitsRecorder(Engine):
    def _decode_step(self, toks, lens):
        logits, g = super()._decode_step(toks, lens)
        self.rows.append(logits.clone())
        return logits, g


@pytest.mark.parametrize("kv,recipes", [(torch.float32, None), ("int8", LAYERWISE),
                                        ("fp8", LAYERWISE)])
def test_world_of_one_engine_is_the_meshless_engine_bit_for_bit(kv, recipes, monkeypatch):
    import torch.distributed as dist

    from llm_fp8_tpu_torch.parallel import MeshConfig, make_mesh, shard_params

    cfg, params = _tree("debug-tiny", recipes, False, monkeypatch)
    ecfg = EngineConfig(max_slots=2, max_seq_len=64, kv_dtype=kv, prefill_buckets=(16, 32),
                        kv_recalibrate=True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh(MeshConfig(), "cpu")):
            eng = _LogitsRecorder(params if mesh is None else shard_params(params, mesh), cfg,
                                  ecfg, device="cpu", mesh=mesh)
            eng.rows = []
            reqs = [eng.add_request(p, SamplingParams(max_new_tokens=5))
                    for p in _prompts(cfg)[:3]]
            eng.run()
            runs.append(([r.output for r in reqs], eng.rows, eng._kscales.clone()))
    finally:
        dist.destroy_process_group()
    (t0, l0, s0), (t1, l1, s1) = runs
    assert t0 == t1 and torch.equal(s0, s1)
    assert len(l0) == len(l1) and all(torch.equal(a, b) for a, b in zip(l0, l1))


def test_engine_mesh_refuses_other_families_above_one_rank():
    from llm_fp8_tpu_torch.models.gpt2 import GPT2_REGISTRY, gpt2_forward, init_gpt2_params

    class Mesh:  # two ranks: refused before any collective
        class mesh:
            @staticmethod
            def numel():
                return 2

    gcfg = GPT2_REGISTRY["debug-gpt2"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        Engine(init_gpt2_params(gcfg, device="cpu"), gcfg,
               EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,)),
               device="cpu", forward_fn=gpt2_forward, mesh=Mesh())
