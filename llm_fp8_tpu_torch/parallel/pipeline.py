"""Pipeline parallelism: the GPipe microbatch schedule over a chain of ranks
(counterpart of ``llm_fp8_tpu/parallel/pipeline.py``).

The layer stack is split into ``n_stages`` contiguous groups, one a rank of
the mesh's ``pp`` axis. The schedule is JAX's fill-steady-drain loop: with
``M`` microbatches and ``S`` stages it runs ``M + S - 1`` ticks; at each
tick every stage runs its layers on what it holds (stage 0 the next
microbatch, the others what the stage before sent at the previous tick), and
the activations hop one stage down (:func:`..parallel.collectives.hop`, an
autograd function: its backward sends the gradient one stage up). As in
JAX every stage computes at every tick (warm-up and drain ticks on zeros or
a repeated microbatch), which keeps the hops of every rank paired in the
backward. The last stage's outputs are summed over the stages (zeros
elsewhere) into a result every rank holds (:func:`replicated_sum`, whose
backward passes the gradient through); the input enters through
:func:`replicated_in`, whose backward sums the stages' gradients (only
stage 0's is non-zero). So the gradients of everything outside the island
come out whole and equal on every rank, and each stage's layers get theirs
on their own rank.

Embedding, final norm and the LM head stay outside the island. No CLI flag
uses this, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from .collectives import group_rank, group_size, hop, replicated_in, replicated_sum
from .mesh import AXIS_PP

__all__ = ["pipeline_apply", "forward_pipelined", "stage_params"]


def stage_params(layer_params: Dict[str, Any], n_stages: int) -> Dict[str, Any]:
    """Stacked layer leaves ``[L, ...] -> [n_stages, L // n_stages, ...]``."""

    def reshape(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return {k: reshape(v) for k, v in layer_params.items()}


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor], staged: Any,
                   x: torch.Tensor, *, mesh, n_microbatches: int, axis_name: str = AXIS_PP,
                   extra: Any = None) -> torch.Tensor:
    """``x [B, S, D]`` through the pipelined layer stack; every rank returns
    the whole ``[B, S, D]``. ``staged``: a dict of ``[n_stages, ...]``
    leaves (every rank may hold them all; this rank runs ``staged[k][its
    stage]``); ``stage_fn(stage_layers, x_mb, extra)`` applies one stage's
    layers to one microbatch."""
    group = mesh.get_group(axis_name)
    S, s = group_size(group), group_rank(group)
    B = x.shape[0]
    M = n_microbatches
    assert B % M == 0, (B, M)
    layers = {k: v[s] for k, v in staged.items()}
    x_mb = replicated_in(x, group).reshape(M, B // M, *x.shape[1:])
    first = torch.tensor(float(s == 0), dtype=x.dtype, device=x.device)
    outs = [None] * M
    prev = torch.zeros_like(x_mb[0])
    for t in range(M + S - 1):
        recv = hop(prev, group) if t > 0 else torch.zeros_like(prev)
        # Both terms stay in the graph on every stage (one with weight 0):
        # each hop's backward then runs on every rank, paired.
        inp = first * x_mb[min(t, M - 1)] + (1 - first) * recv
        prev = stage_fn(layers, inp, extra)
        if t >= S - 1:
            outs[t - (S - 1)] = prev
    last = torch.tensor(float(s == S - 1), dtype=x.dtype, device=x.device)
    out = torch.stack(outs) * last
    return replicated_sum(out, group).reshape(x.shape)


def forward_pipelined(params: Dict[str, Any], tokens: torch.Tensor, cfg, *, mesh,
                      n_microbatches: int = 4, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The Llama/Qwen forward with the decoder stack pipelined over the
    mesh's ``pp`` axis; returns logits ``[B, S, V]`` float32 on every rank.
    Embedding, final norm and LM head run outside the island."""
    from ..models.llama import _layer_body, _lm_head, _rope_tables, unstack_layers
    from ..ops.attention import attention
    from ..ops.rmsnorm import rmsnorm

    dev = params["embed"].device
    tokens = tokens.to(dev)
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(compute_dtype)
    cos, sin = _rope_tables(cfg, torch.arange(S, dtype=torch.int32, device=dev)[None, :])
    staged = stage_params(params["layers"], group_size(mesh.get_group(AXIS_PP)))

    def attend(q, kk, vv):
        return attention(q, kk, vv, causal=True, window=cfg.sliding_window)

    def stage_fn(layers, x_mb, extra):
        for lp in unstack_layers(layers):
            x_mb = _layer_body(x_mb, lp, cos, sin, cfg, attend)
        return x_mb

    x = pipeline_apply(stage_fn, staged, x, mesh=mesh, n_microbatches=n_microbatches)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _lm_head(params, x, cfg)
