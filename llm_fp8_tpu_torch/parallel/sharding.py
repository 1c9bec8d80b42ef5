"""Sharding rules by parameter name (counterpart of
``llm_fp8_tpu/parallel/sharding.py``), placed as ``DTensor``s.

A spec is JAX's ``PartitionSpec`` as a tuple: one entry per tensor dim, a
mesh axis name, a tuple of names, or None. :func:`param_specs` and
:func:`_spec_for_leaf` are pure functions of leaf names, shapes and a
``{axis: size}`` mapping (:func:`..parallel.mesh.axis_sizes`), so their
result can be compared with JAX's without a world. :func:`shard_params`
turns a full tree into ``DTensor`` leaves: ``Shard(d)`` on each mesh dim a
spec names, ``Replicate()`` on the others, each rank keeping only its slice
(``DTensor.from_local``: no communication). ``QTensor`` codes and scales
follow the rule of their parameter by name and rank, as JAX's walk does;
size-1 and indivisible dims stay replicated.

What maps to what (the reference's module zoo): column-parallel products
shard a weight's output dim over ``tp`` (wqkv, w_gate_up, lm_head),
row-parallel ones the input dim (wo, w_down), the vocab-parallel embedding
its vocab dim; FSDP FULL_SHARD shards every weight over ``fsdp`` as well.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from ..quant import QTensor
from .mesh import AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_TP, axis_sizes

__all__ = ["param_specs", "shard_params", "placements", "slice_of",
           "full_tensor", "gather_tree", "batch_spec", "activation_spec", "kv_cache_spec",
           "constrain", "adapt_spec"]

#: Canonical axis per tensor dim of each stacked parameter leaf (JAX's
#: ``_RULES``, whole: the Llama, GPT-2/NeoX, MoE and MLA families' names;
#: unlisted leaves replicate).
_RULES: Dict[str, tuple] = {
    "embed": (AXIS_TP, AXIS_FSDP),
    "lm_head": (AXIS_FSDP, AXIS_TP),
    "final_norm": (None,),
    "wqkv": (None, AXIS_FSDP, AXIS_TP),
    "bqkv": (None, AXIS_TP),
    "wo": (None, AXIS_TP, AXIS_FSDP),
    "w_gate_up": (None, AXIS_FSDP, AXIS_TP),
    "w_down": (None, AXIS_TP, AXIS_FSDP),
    "norm_attn": (None, None),
    "norm_mlp": (None, None),
    "q_norm": (None, None),
    "k_norm": (None, None),
    "wte": (AXIS_TP, AXIS_FSDP),
    "w_qkv": (None, AXIS_FSDP, AXIS_TP),
    "b_qkv": (None, AXIS_TP),
    "w_out": (None, AXIS_TP, AXIS_FSDP),
    "w_fc": (None, AXIS_FSDP, AXIS_TP),
    "b_fc": (None, AXIS_TP),
    "w_proj": (None, AXIS_TP, AXIS_FSDP),
    "w_router": (None, None, None),
    "wq": (None, AXIS_FSDP, AXIS_TP),
    "wq_a": (None, AXIS_FSDP, None),
    "wq_b": (None, AXIS_FSDP, AXIS_TP),
    "w_kv_a": (None, AXIS_TP, AXIS_FSDP),
    "w_kv_b": (None, AXIS_FSDP, AXIS_TP),
    "w_shared_gate_up": (None, AXIS_FSDP, AXIS_TP),
    "w_shared_down": (None, AXIS_TP, AXIS_FSDP),
}

#: The MoE family's 4-D ``[L, E, K, N]`` experts (the dense families' same
#: names are 3-D): the expert dim on ``ep``.
_RULES_BY_NDIM: Dict[tuple, tuple] = {
    ("w_gate_up", 4): (None, AXIS_EP, AXIS_FSDP, AXIS_TP),
    ("w_down", 4): (None, AXIS_EP, AXIS_TP, AXIS_FSDP),
}


def _spec_for_leaf(name: str, shape, sizes: Mapping[str, int]) -> tuple:
    """The spec of one leaf: its rule (by name and rank), with every dim of
    size 1 or not divisible by its axis replicated; ``()`` (replicated) for
    a leaf without a rule or of another rank."""
    rule = _RULES_BY_NDIM.get((name, len(shape)), _RULES.get(name))
    if rule is None or len(rule) != len(shape):
        return ()
    return tuple(None if ax is None or dim % sizes[ax] != 0 or dim == 1 else ax
                 for ax, dim in zip(rule, shape))


def _qtensor_parts(q: QTensor):
    return {"qvalue": q.qvalue, "scale": q.scale}


def param_specs(params: Dict[str, Any], sizes) -> Dict[str, Any]:
    """A tree congruent to ``params`` of specs (``sizes``: ``{axis: size}``
    or a mesh). A ``QTensor`` leaf gives a ``QTensor``-shaped dict
    ``{"qvalue": spec, "scale": spec}``."""
    if not isinstance(sizes, Mapping):
        sizes = axis_sizes(sizes)

    def walk(tree, name: Optional[str]):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return {k: _spec_for_leaf(name or "", t.shape, sizes)
                    for k, t in _qtensor_parts(tree).items()}
        return _spec_for_leaf(name or "", tree.shape, sizes)

    return walk(params, None)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the mesh
    dim each tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, ax in enumerate(spec):
        for name in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


def slice_of(full: torch.Tensor, placements_, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under DTensor ``placements_`` (a view;
    mesh dims in order, as DTensor nests them)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            out = out.chunk(mesh.mesh.shape[i], dim=p.dim)[coord[i]]
    return out


def _place(t: torch.Tensor, spec: tuple, mesh):
    from torch.distributed.tensor import DTensor

    places = placements(spec, mesh)
    local = slice_of(t.detach(), places, mesh).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, places, run_check=False)


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """``params`` placed on ``mesh`` by the rules: every tensor a ``DTensor``
    holding this rank's slice (QTensors keep their fields around DTensor
    codes and scales). The full tensors are not kept."""
    specs = param_specs(params, mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, QTensor):
            return dataclasses.replace(tree, qvalue=_place(tree.qvalue, spec["qvalue"], mesh),
                                       scale=_place(tree.scale, spec["scale"], mesh))
        return _place(tree, spec, mesh)

    return walk(params, specs)


def full_tensor(t):
    """A DTensor's full value (a collective: every rank calls it); any
    other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def gather_tree(tree):
    """A tree with every DTensor (QTensor fields too) replaced by its full
    value, detached: what a checkpoint or an export writes."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, qvalue=full_tensor(tree.qvalue).detach(),
                                   scale=full_tensor(tree.scale).detach())
    if isinstance(tree, torch.Tensor):
        return full_tensor(tree).detach()
    return tree


def batch_spec() -> tuple:
    """Token batches shard over both data axes (dp x fsdp act as data)."""
    return ((AXIS_DP, AXIS_FSDP),)


def activation_spec(sp: bool = False) -> tuple:
    """Hidden states ``[B, S, D]``; ``sp=True``: the sequence over ``tp``
    between blocks (Megatron sequence parallelism)."""
    return ((AXIS_DP, AXIS_FSDP), AXIS_TP if sp else None, None)


def kv_cache_spec() -> tuple:
    """KV arena ``[L, B, S, Hk, Dh]``: batch over the data axes, heads over tp."""
    return (None, (AXIS_DP, AXIS_FSDP), None, AXIS_TP, None)


def adapt_spec(spec: tuple, shape, sizes) -> tuple:
    """``spec`` with the axes that do not divide the array dropped (small
    models on big meshes)."""
    if not isinstance(sizes, Mapping):
        sizes = axis_sizes(sizes)
    out = []
    for ax, dim in zip(spec, shape):
        names = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        size = 1
        for n in names:
            size *= sizes[n]
        out.append(ax if names and dim > 1 and dim % size == 0 else None)
    return tuple(out)


def constrain(x, mesh, spec: tuple):
    """``x`` (a DTensor, or a full tensor every rank holds) redistributed to
    ``spec`` on ``mesh`` (JAX's ``with_sharding_constraint``)."""
    from torch.distributed.tensor import DTensor, Replicate

    spec = adapt_spec(spec, x.shape, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate() for _ in mesh.mesh_dim_names],
                               run_check=False)
    return x.redistribute(mesh, placements(spec, mesh))

