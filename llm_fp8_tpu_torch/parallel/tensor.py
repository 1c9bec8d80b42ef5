"""Tensor parallelism for serving the Llama family (Megatron's split, written
out where the JAX package lets GSPMD place the same function over ``tp``).

A rank keeps, of the whole parameter tree (:func:`tp_rank_params`):

* ``wqkv``/``bqkv`` ``[D, q|k|v]``: the columns of its q heads
  ``[r·Hq/tp, (r+1)·Hq/tp)`` and of the matching k and v heads, by heads,
  not a contiguous ``1/tp`` of the fused columns (which would give rank 0
  all of q and no k or v); ``wo``: the rows of its q heads;
* ``w_gate_up`` ``[D, gate|up]``: its slice of gate and its slice of up,
  concatenated; ``w_down``: the rows of its slice of the intermediate dim;
* ``embed``: its rows of the vocabulary (the vocab-parallel embedding);
  ``lm_head``: its columns of the vocabulary (a tied head is ``embed.T``);
* the norms and QK-norm weights whole.

``QTensor`` codes and scales are cut alike: a per-output-channel scale
``[1, N]`` goes with the columns of a column-parallel weight and stays whole
on a row-parallel one; group-wise and MX scales go with K's cut in whole
blocks. The whole weight is quantized first and then cut (a per-channel
scale is an amax over all of K), and each shard is laid out for the
``qdot`` route afterwards (``serving_layout``: its own zero-padded,
contiguous codes), never sliced out of a padded layout.

A part whose size ``tp`` does not divide is replicated, as JAX's
``_spec_for_leaf`` replicates an indivisible dim: every rank computes it
whole and nothing is reduced after it. The attention's split is decided on
``Hq`` and ``Hk`` together (a q head never loses its kv head), and a
row-parallel weight whose group-wise or MX blocks would straddle the cut
replicates its part too (:func:`tp_layout`).

The forward of a rank (``models/llama.py``, ``tp=``) all-reduces the
float32 outputs of ``wo`` and ``w_down`` over the group and casts once,
all-reduces the embedding (each id is held by one rank, the others write
zeros), all-gathers the float32 logits along the vocabulary, takes the
ALiBi slopes of its heads out of the whole model's, and quantizes the input
of a row-parallel fp8 product with each row's amax taken over the group
(``quant/dot.py::k_split_over``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..quant.dot import serving_layout
from ..quant.qtensor import QTensor, _pack_int4

__all__ = ["TPLayout", "TPRank", "tp_layout", "tp_rank_params", "tp_rank_config",
           "qkv_columns", "tp_shard", "local_tp_ranks"]


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which parts of a model are split over ``size`` tp ranks."""

    size: int
    heads: bool  # attention: q/k/v heads, wo's rows
    mlp: bool  # the intermediate dim: gate|up's columns, w_down's rows
    vocab: bool  # embed's rows, lm_head's columns


@dataclasses.dataclass(frozen=True)
class TPRank:
    """What a rank's forward needs: its group (a process group, a
    :class:`~.collectives.LocalGroup`, or None for a group of one without
    collectives), its place in it, the layout and the whole model's q
    heads (ALiBi slopes)."""

    group: Any
    rank: int
    layout: TPLayout
    num_heads: int


def _blocks_fit(w, rows: int) -> bool:
    """Whether a row-parallel weight's scales can be cut at ``rows`` rows a
    rank: group-wise and MX blocks must not straddle the cut."""
    if not isinstance(w, QTensor) or w.block_size is None:
        return True
    return rows % w.block_size == 0


def tp_layout(params: Dict[str, Any], cfg: ModelConfig, size: int) -> TPLayout:
    """The parts of ``cfg`` (with ``params``' formats) that split over
    ``size`` ranks."""
    layers = params["layers"]
    heads = (cfg.num_heads % size == 0 and cfg.num_kv_heads % size == 0
             and _blocks_fit(layers["wo"], cfg.q_dim // size))
    mlp = (cfg.intermediate_size % size == 0
           and _blocks_fit(layers["w_down"], cfg.intermediate_size // size))
    return TPLayout(size=size, heads=heads, mlp=mlp, vocab=cfg.vocab_size % size == 0)


def tp_rank_config(cfg: ModelConfig, layout: TPLayout) -> ModelConfig:
    """A rank's config: its q and kv heads and its intermediate dim (the
    vocabulary stays whole: the logits are gathered)."""
    n = layout.size
    out = cfg
    if layout.heads:
        out = dataclasses.replace(out, num_heads=cfg.num_heads // n,
                                  num_kv_heads=cfg.num_kv_heads // n)
    if layout.mlp:
        out = dataclasses.replace(out, intermediate_size=cfg.intermediate_size // n)
    return out


def _span(start: int, length: int, device) -> torch.Tensor:
    return torch.arange(start, start + length, device=device)


def qkv_columns(cfg: ModelConfig, rank: int, size: int, device=None) -> torch.Tensor:
    """The fused ``[q|k|v]`` columns of rank ``rank``'s heads."""
    hq, hk, d = cfg.num_heads // size, cfg.num_kv_heads // size, cfg.head_dim
    return torch.cat([_span(rank * hq * d, hq * d, device),
                      _span(cfg.q_dim + rank * hk * d, hk * d, device),
                      _span(cfg.q_dim + cfg.kv_dim + rank * hk * d, hk * d, device)])


def _halves_columns(width: int, rank: int, size: int, device=None) -> torch.Tensor:
    """The ``[gate|up]`` columns of rank ``rank``'s slice of each half."""
    n = width // size
    return torch.cat([_span(rank * n, n, device), _span(width + rank * n, n, device)])


def _cut(t, axis: int, idx: torch.Tensor):
    """``t`` (a tensor or a QTensor, stacked or not) at indices ``idx`` of
    ``axis`` (-1: columns, -2: rows of the contraction, 0: an embedding's
    rows), as a fresh contiguous tensor laid out for its ``qdot`` route."""
    if not isinstance(t, QTensor):
        return t.index_select(axis % t.ndim, idx.to(t.device)).contiguous()
    codes = t.unpack().contiguous()  # logical [..., K, N], unpadded, row-major
    idx = idx.to(codes.device)
    codes = codes.index_select(axis % codes.ndim, idx)
    scale = t.scale
    if axis == -1 and scale.shape[-1] > 1:
        scale = scale.index_select(scale.ndim - 1, idx.to(scale.device))
    elif axis == -2 and t.block_size is not None:
        blocks = idx[::t.block_size] // t.block_size
        scale = scale.index_select(scale.ndim - 2, blocks.to(scale.device))
    if t.pack_axis is not None:
        codes = _pack_int4(codes, t.pack_axis % codes.ndim)
    q = dataclasses.replace(t, qvalue=codes, scale=scale.contiguous())
    return serving_layout(q)


def tp_rank_params(params: Dict[str, Any], cfg: ModelConfig, rank: int, size: int,
                   layout: Optional[TPLayout] = None) -> Dict[str, Any]:
    """Rank ``rank``'s shard of the whole tree ``params`` over ``size`` tp
    ranks (module docstring). ``layout``: :func:`tp_layout`'s, by default."""
    layout = layout or tp_layout(params, cfg, size)
    layers = dict(params["layers"])
    dev = params["embed"].device
    if layout.heads:
        cols = qkv_columns(cfg, rank, size, dev)
        hq = cfg.q_dim // size
        layers["wqkv"] = _cut(layers["wqkv"], -1, cols)
        if "bqkv" in layers:
            layers["bqkv"] = _cut(layers["bqkv"], -1, cols)
        layers["wo"] = _cut(layers["wo"], -2, _span(rank * hq, hq, dev))
    if layout.mlp:
        n = cfg.intermediate_size // size
        layers["w_gate_up"] = _cut(layers["w_gate_up"], -1,
                                   _halves_columns(cfg.intermediate_size, rank, size, dev))
        layers["w_down"] = _cut(layers["w_down"], -2, _span(rank * n, n, dev))
    out = dict(params, layers=layers)
    if layout.vocab:
        n = cfg.vocab_size // size
        rows = _span(rank * n, n, dev)
        out["embed"] = _cut(params["embed"], 0, rows)
        if "lm_head" in params and not cfg.tie_word_embeddings:
            out["lm_head"] = _cut(params["lm_head"], -1, rows)
    return out


def tp_shard(params: Dict[str, Any], cfg: ModelConfig, size: int, rank: int, group,
             layout: Optional[TPLayout] = None):
    """Rank ``rank``'s ``(shard, config, TPRank)`` of the whole tree
    ``params`` over the tp group ``group`` of ``size`` ranks (``layout``:
    :func:`tp_layout`'s, by default)."""
    layout = layout or tp_layout(params, cfg, size)
    return (tp_rank_params(params, cfg, rank, size, layout), tp_rank_config(cfg, layout),
            TPRank(group, rank, layout, cfg.num_heads))


def local_tp_ranks(params: Dict[str, Any], cfg: ModelConfig, size: int, group=None):
    """The ranks of a tp group of ``size`` in this process: ``[(shard,
    config, TPRank)]`` over one :class:`~.collectives.LocalGroup` (``group``:
    one that another model's ranks meet on, as a speculative draft's meet on
    its target's; a new one by default). Run a forward of every rank with
    ``ranks[0][2].group.run(lambda r: ...)``; their collectives meet in rank
    order."""
    from .collectives import LocalGroup

    layout = tp_layout(params, cfg, size)
    group = group or LocalGroup(size)
    return [tp_shard(params, cfg, size, r, group, layout) for r in range(size)]
