"""Tensor-parallel serving in the port (``parallel/tensor.py``, the ``tp``
forward of ``models/llama.py``, ``quant/dot.py::k_split_over``,
``Engine(mesh=)``, ``SpecEngine(mesh=)``) against the mesh-less port and the
JAX package.

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
  whole model's. K1 plans a rank's split ``wqkv`` and ``w_gate_up`` as
  the whole product (the same split of K: each column summed in the
  whole product's order), and the row-parallel products as themselves.
* Planted faults break the composition: ``wqkv`` cut contiguously, the
  row-parallel amax left local, ALiBi slopes rebuilt per rank.
* One speculative round composed over tp 4 (both caches prefilled, the
  draft's feeds, the verify block at ragged offsets; target and draft
  split over one group) proposes the mesh-less round's tokens and gives its
  verify logits within 1e-5 relative. A data group's draws are its rows of
  the whole batch's.

A gloo world of 4 CPU processes (``tests/torch_dist_worker.py`` ``serve``,
one launch) serves debug-small (float32 weights, JAX's initializer) over tp
4, fsdp 2 x tp 2 and dp 2 x tp 2: four greedy requests give the mesh-less
port engine's tokens, which are JAX's greedy reference (``attn_impl="ref"``,
as ``tests/test_serving.py`` computes it); a sampled request gives the same
tokens on every rank of the tp group; int8 KV over dp 2 x tp 2: every
rank's scales after each prefill (the calibration and a recalibration
among them) are the mesh-less engine's slice. In the same world
``SpecEngine(mesh=)`` (debug-small with the target's first layer as draft)
over tp 4, dp 2 x tp 2 and fsdp 2 x tp 2, and with a draft of 2 kv heads
that tp 4 keeps whole, gives JAX's greedy tokens (greedy speculation is
greedy decoding) and the mesh-less SpecEngine's per-round accepted counts;
a sampled run over dp 2 x tp 2 commits the mesh-less engine's tokens on
every rank. Worlds of one in this process: tokens and every step's (every
round's verify) logits bit for bit against the mesh-less engine (spec
engine), greedy and sampled. Another family above one rank is refused.
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
from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams, SpecEngine
from llm_fp8_tpu_torch.serving.spec_engine import draw, leviathan_accept
from torch_dist_worker import free_port, launch_world, serve_engine, serve_result

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


#: Column-parallel products of a tp 4 shard, ``(M, N, K)`` of the whole:
#: Llama-3.1-8B's at the verify block (M = 40, the decode kernel) and
#: Qwen2.5-14B's at a prefill (M = 1024, the prefill kernel).
COLUMN_PRODUCTS = {
    "8b wqkv M=40": (40, 6144, 4096), "8b gate|up M=40": (40, 28672, 4096),
    "8b lm_head M=40": (40, 128256, 4096), "14b wqkv M=1024": (1024, 7168, 5120),
    "14b gate|up M=1024": (1024, 27648, 5120), "14b wqkv M=8": (8, 7168, 5120),
}


@pytest.mark.parametrize("case", list(COLUMN_PRODUCTS))
def test_k1_plans_a_column_shard_as_the_whole_product(case):
    """Within ``planned_as_whole(4)`` a rank's ``[K, N/4]`` shard takes the
    whole product's rows a block and split of K, so its columns sum in the
    whole product's order; alone, the narrower shard plans otherwise."""
    from llm_fp8_tpu_torch.kernels import quant_matmul as k1

    M, N, K = COLUMN_PRODUCTS[case]
    prefill = M >= k1.PREFILL_MIN_M
    whole = k1.launch_plan(M, N, K, 132, prefill)
    with k1.planned_as_whole(4):
        assert k1.launch_plan(M, N // 4, K, 132, prefill) == whole
    assert k1.launch_plan(M, N, K, 132, prefill) == whole
    if case == "8b wqkv M=40":
        assert k1.launch_plan(M, N // 4, K, 132, prefill) != whole


def test_tp_forward_plans_only_the_split_column_products_as_the_whole(monkeypatch):
    """Each rank's K1 calls (the fused route; threads of a ``LocalGroup``):
    the split ``wqkv`` and ``w_gate_up`` are planned as their whole product,
    the row-parallel ``wo`` and ``w_down`` as themselves, and the setting is
    the calling thread's alone."""
    import threading

    from llm_fp8_tpu_torch.kernels import quant_matmul as k1

    monkeypatch.setenv("LLM_FP8_QDOT", "fused")
    cfg = get_config("debug-small")
    params = quantize_params(init_params(cfg, dtype=torch.float32, device="cpu", seed=3),
                             LAYERWISE)
    seen, lock, plain = set(), threading.Lock(), k1.quant_matmul_plain

    def spy(x, w_q, scale, **kw):
        with lock:
            seen.add((tuple(w_q.shape), k1._PARTS.n))
        return plain(x, w_q, scale, **kw)

    monkeypatch.setattr(k1, "quant_matmul_plain", spy)
    ranks = ptensor.local_tp_ranks(params, cfg, 2)
    ranks[0][2].group.run(lambda r: forward(ranks[r][0], _tokens(cfg), ranks[r][1],
                                            tp=ranks[r][2]))
    D, I = cfg.hidden_size, cfg.intermediate_size
    assert seen == {((D, cfg.qkv_dim // 2), 2), ((D, I), 2), ((cfg.q_dim // 2, D), 1),
                    ((I // 2, D), 1)}
    assert k1._PARTS.n == 1


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


#: The spec runs' sampling: top_k 20 at temperature 0.8, the engine's seed.
SPEC_SAMPLED = dict(temperature=0.8, top_k=20, seed=5)
TP4, DP2_TP2, FSDP2_TP2 = dict(tp=4), dict(dp=2, fsdp=1, tp=2), dict(fsdp=2, tp=2)


def _runs(cfg):
    greedy = [(p, GREEDY) for p in _prompts(cfg)]
    return {
        "tp4": dict(mesh=TP4, sharded=False, ecfg=ECFG,
                    requests=greedy + [(_prompts(cfg)[1], SAMPLED)]),
        "fsdp2_tp2": dict(mesh=FSDP2_TP2, sharded=True, ecfg=ECFG, requests=greedy),
        "dp2_tp2": dict(mesh=DP2_TP2, sharded=False, ecfg=ECFG, requests=greedy),
        "int8_dp2_tp2": dict(mesh=DP2_TP2, sharded=False, ecfg=INT8,
                             requests=[(p, GREEDY) for p in _int8_prompts(cfg)]),
        # SpecEngine(mesh=): the draft is debug-small cut to one layer, or
        # (``kv2``) a one-layer draft of 2 kv heads, which tp 4 leaves whole.
        "spec_tp4": dict(mesh=TP4, sharded=False, ecfg=ECFG, requests=greedy,
                         spec=dict(draft="cut")),
        "spec_dp2_tp2": dict(mesh=DP2_TP2, sharded=False, ecfg=ECFG, requests=greedy,
                             spec=dict(draft="cut")),
        "spec_fsdp2_tp2": dict(mesh=FSDP2_TP2, sharded=True, ecfg=ECFG, requests=greedy,
                               spec=dict(draft="cut")),
        "spec_tp4_draft_whole": dict(mesh=TP4, sharded=False, ecfg=ECFG, requests=greedy,
                                     spec=dict(draft="kv2")),
        # One prompt in every slot: slots 0-1 and 2-3 are two data groups'.
        "spec_sampled_dp2_tp2": dict(mesh=DP2_TP2, sharded=False, ecfg=ECFG,
                                     requests=[(_prompts(cfg)[1], SAMPLED)] * 4,
                                     spec=dict(draft="cut", **SPEC_SAMPLED)),
    }


def _drafts(jparams, jcfg):
    """The spec runs' drafts, ``name -> (port config, numpy tree)``: the
    target cut to its first layer, and a one-layer draft of 2 kv heads
    (JAX's initializer)."""
    cut = jax.tree_util.tree_map(np.asarray, dict(
        jparams, layers=jax.tree_util.tree_map(lambda t: t[:1], jparams["layers"])))
    jkv2 = dataclasses.replace(jcfg, num_layers=1, num_kv_heads=2)
    kv2 = jax.tree_util.tree_map(np.asarray,
                                 jllama.init_params(jkv2, jax.random.PRNGKey(13),
                                                    dtype=jnp.float32))
    cfg = get_config(MODEL)
    return {"cut": (dataclasses.replace(cfg, num_layers=1), cut),
            "kv2": (dataclasses.replace(cfg, num_layers=1, num_kv_heads=2), kv2)}


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


def _meshless(np_params, cfg, run, drafts):
    drafts = {k: (c, params_from_numpy(t)) for k, (c, t) in drafts.items()}
    eng = serve_engine(run, params_from_numpy(np_params), cfg, drafts)
    reqs = [eng.add_request(p, SamplingParams(**sp)) for p, sp in run["requests"]]
    eng.run()
    return serve_result(eng, reqs, drafts[run["spec"]["draft"]][0] if "spec" in run else None)


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve")
    jcfg = jconfig.get_config(MODEL)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(12), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = get_config(MODEL)
    runs = _runs(cfg)
    drafts = _drafts(jparams, jcfg)
    outs = launch_world("serve", work, dict(model=MODEL, params=np_params, runs=runs,
                                            drafts=drafts))
    refs = {name: _meshless(np_params, cfg, run, drafts) for name, run in runs.items()}
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


SPEC_GREEDY_RUNS = ["spec_tp4", "spec_dp2_tp2", "spec_fsdp2_tp2", "spec_tp4_draft_whole"]


@pytest.mark.parametrize("name", SPEC_GREEDY_RUNS)
def test_world_spec_greedy_tokens_and_accepted_counts(serve_world, name):
    """Greedy speculation commits plain greedy decoding's tokens: JAX's, and
    the mesh-less SpecEngine's with its per-round accepted counts."""
    outs, refs, jax_tokens = serve_world
    assert refs[name]["tokens"] == jax_tokens
    assert 0 < max(refs[name]["accepted"])  # the draft is accepted in some rounds
    for o in outs:
        assert o[name]["tokens"] == jax_tokens
        assert o[name]["accepted"] == refs[name]["accepted"]


def test_world_spec_sampled_requests_are_the_meshless_engines_on_every_rank(serve_world):
    """One prompt in all four slots over dp 2 x tp 2: every rank commits the
    mesh-less engine's tokens and accepted counts, so the ranks of a tp
    group draw alike and the two data groups draw their own rows of the
    batch's numbers (a group drawing only its rows from the seed, as its
    peer group does, fails this)."""
    outs, refs, _ = serve_world
    ref = refs["spec_sampled_dp2_tp2"]
    tokens = ref["tokens"]
    assert all(len(t) == SAMPLED["max_new_tokens"] for t in tokens)
    assert tokens[0] != tokens[2] and tokens[1] != tokens[3]
    for o in outs:
        assert o["spec_sampled_dp2_tp2"]["tokens"] == tokens
        assert o["spec_sampled_dp2_tp2"]["accepted"] == ref["accepted"]


def test_a_data_groups_draws_are_its_rows_of_the_batchs_draw():
    """``draw`` and ``leviathan_accept`` with ``rows = (B, s0)`` take rows
    ``s0..`` of what the whole batch draws from the same generator state."""
    g = torch.Generator().manual_seed(9)
    probs = torch.rand((4, 3, 50), generator=torch.Generator().manual_seed(1)) + 0.01
    props = torch.randint(0, 50, (4, 2), generator=torch.Generator().manual_seed(2))
    state = g.get_state()
    whole = (draw(probs[:, 0], g), *leviathan_accept(props, probs[:, :2], probs, g))
    for s0 in (0, 2):
        g.set_state(state)
        part = (draw(probs[s0:s0 + 2, 0], g, (4, s0)),
                *leviathan_accept(props[s0:s0 + 2], probs[s0:s0 + 2, :2], probs[s0:s0 + 2], g,
                                  (4, s0)))
        assert all(torch.equal(p, w[s0:s0 + 2]) for p, w in zip(part, whole))


def test_world_spec_draft_layout(serve_world):
    """The draft's cache holds the rank's slots and kv heads; a draft whose
    kv heads tp 4 does not divide stays whole on every rank, its cache with
    all its heads."""
    outs, _, _ = serve_world
    L, S = 1, ECFG["max_seq_len"]
    for o in outs:
        assert o["spec_tp4"]["draft_split"] and not o["spec_tp4"]["draft_whole"]
        assert o["spec_tp4"]["draft_cache"] == (L, 4, S, 1, 64)
        assert o["spec_dp2_tp2"]["draft_cache"] == (L, 2, S, 2, 64)
        assert o["spec_fsdp2_tp2"]["draft_cache"] == (L, 2, S, 2, 64)
        whole = o["spec_tp4_draft_whole"]
        assert not whole["draft_split"] and whole["draft_whole"]
        assert whole["draft_cache"] == (L, 4, S, 2, 64)


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


class _TwoRanks:  # a mesh of two ranks: refused before any collective
    class mesh:
        @staticmethod
        def numel():
            return 2


REFUSAL = "The other families over a mesh"


def test_engine_mesh_refuses_other_families_above_one_rank():
    from llm_fp8_tpu_torch.models.gpt2 import GPT2_REGISTRY, gpt2_forward, init_gpt2_params

    gcfg = GPT2_REGISTRY["debug-gpt2"]
    with pytest.raises(NotImplementedError, match=REFUSAL):
        Engine(init_gpt2_params(gcfg, device="cpu"), gcfg,
               EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(32,)),
               device="cpu", forward_fn=gpt2_forward, mesh=_TwoRanks())


@pytest.mark.parametrize("which", ["target", "draft"])
def test_spec_engine_mesh_refuses_other_families_above_one_rank(which):
    """A GPT-2 target, or a GPT-2 draft beside a Llama target, over two
    ranks."""
    from llm_fp8_tpu_torch.models.gpt2 import GPT2_REGISTRY, gpt2_forward, init_gpt2_params

    gcfg = GPT2_REGISTRY["debug-gpt2"]
    lcfg = dataclasses.replace(get_config("debug-tiny"), vocab_size=gcfg.vocab_size)
    gpt2 = (init_gpt2_params(gcfg, device="cpu"), gcfg, gpt2_forward)
    llama = (init_params(lcfg, dtype=torch.float32, device="cpu"), lcfg, None)
    (tp, tc, tf), (dp, dc, df) = (gpt2, llama) if which == "target" else (llama, gpt2)
    with pytest.raises(NotImplementedError, match=REFUSAL):
        SpecEngine(tp, tc, dp, dc, EngineConfig(max_slots=2, max_seq_len=64,
                                                prefill_buckets=(32,)),
                   device="cpu", forward_fn=tf, draft_forward_fn=df, mesh=_TwoRanks())


class _VerifyRecorder(SpecEngine):
    def _verify(self, block, lens):
        logits = super()._verify(block, lens)
        self.rows.append(logits.clone())
        return logits


@pytest.mark.parametrize("mode", ["greedy f32", "sampled f32", "greedy fp8 weights fp8 kv"])
def test_world_of_one_spec_engine_is_the_meshless_spec_engine_bit_for_bit(mode, monkeypatch):
    """Tokens, per-round accepted counts and every round's verify logits."""
    import torch.distributed as dist

    from llm_fp8_tpu_torch.parallel import MeshConfig, make_mesh, shard_params

    recipes = LAYERWISE if "fp8 weights" in mode else None
    cfg, params = _tree("debug-tiny", recipes, False, monkeypatch)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams = init_params(dcfg, dtype=torch.float32, device="cpu", seed=4)
    if recipes is not None:
        dparams = quantize_params(dparams, recipes)
    kv = "fp8" if "fp8 kv" in mode else torch.float32
    ecfg = EngineConfig(max_slots=2, max_seq_len=64, kv_dtype=kv, prefill_buckets=(16, 32))
    sampling = SPEC_SAMPLED if mode.startswith("sampled") else {}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh(MeshConfig(), "cpu")):
            tree = (lambda t: t) if mesh is None else (lambda t: shard_params(t, mesh))
            eng = _VerifyRecorder(tree(params), cfg, tree(dparams), dcfg, ecfg, device="cpu",
                                  mesh=mesh, **sampling)
            eng.rows = []
            reqs = [eng.add_request(p, SamplingParams(max_new_tokens=9))
                    for p in _prompts(cfg)[:3]]
            eng.run()
            runs.append(([r.output for r in reqs], list(eng.accepted_histogram), eng.rows))
    finally:
        dist.destroy_process_group()
    (t0, a0, l0), (t1, a1, l1) = runs
    assert t0 == t1 and a0 == a1
    assert len(l0) == len(l1) and all(torch.equal(a, b) for a, b in zip(l0, l1))


def test_composed_spec_round_equals_the_meshless_round(monkeypatch):
    """Prefills of both caches and one speculative round (the draft's g + 1
    feeds, the target's verify block at ragged offsets), float32, target
    and draft each split over one tp group of 4: the proposals equal the
    mesh-less round's, and the verify logits within ``REL``."""
    cfg, params = _tree("debug-small", None, False, monkeypatch)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams = dict(params, layers={k: v[:1] for k, v in params["layers"].items()})
    toks = _tokens(cfg, S=16)
    lens = torch.tensor([16, 11], dtype=torch.int32)
    last = _tokens(cfg, S=1, seed=1)[:, 0]
    g = 4

    def round_(t, tc, d, dc, ttp=None, dtp=None):
        def kw(tp):
            return dict(compute_dtype=torch.float32, **({} if tp is None else {"tp": tp}))

        cache = tllama.init_kv_cache(tc, 2, 32, dtype=torch.float32, device="cpu")
        dcache = tllama.init_kv_cache(dc, 2, 32, dtype=torch.float32, device="cpu")
        forward(t, toks, tc, cache=cache, start_pos=0, kv_lens=lens, **kw(ttp))
        forward(d, toks, dc, cache=dcache, start_pos=0, kv_lens=lens, **kw(dtp))
        tok, pos, props = last, lens, []
        for _ in range(g + 1):
            logits, _ = forward(d, tok[:, None], dc, cache=dcache, start_pos=pos,
                                kv_lens=pos + 1, **kw(dtp))
            tok = logits[:, 0].argmax(-1).to(torch.int32)
            props.append(tok)
            pos = pos + 1
        block = torch.cat([last[:, None], torch.stack(props[:g], dim=1)], dim=1)
        logits, _ = forward(t, block, tc, cache=cache, start_pos=lens, kv_lens=lens + g + 1,
                            **kw(ttp))
        return block, logits

    ref_block, ref = round_(params, cfg, dparams, dcfg)
    ranks = ptensor.local_tp_ranks(params, cfg, 4)
    dranks = ptensor.local_tp_ranks(dparams, dcfg, 4, ranks[0][2].group)
    got = ranks[0][2].group.run(lambda r: round_(*ranks[r][:2], *dranks[r][:2], ranks[r][2],
                                                 dranks[r][2]))
    for block, logits in got:
        assert torch.equal(block, ref_block)
        assert _rel(logits, ref) <= REL, _rel(logits, ref)
