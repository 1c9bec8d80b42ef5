"""Parameter-sharded data parallelism for the trainer: what XLA schedules
from the sharding specs in the JAX package (the per-layer all-gathers of
FSDP FULL_SHARD and the gradients' reduce-scatter), done by hand.

Each rank holds its slice of every parameter (``parallel/sharding.py``).
:func:`gather_param` all-gathers a slice over the mesh axes its spec names
(:func:`..parallel.collectives.gather_shards`: the backward
reduce-scatters); :class:`ShardedLayers` keeps the stacked layer leaves
sharded and hands ``models/llama.py`` one gathered layer at a time
(``unstack_layers``), so a layer's weights are gathered just before it runs
and the kernels take plain tensors. :func:`reduce_grads` then sums each
gradient over the data ranks the gather did not already sum over.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import torch
import torch.distributed as dist

from .collectives import gather_shards

__all__ = ["gather_param", "ShardedLayers", "forward_tree", "sharded_axes", "reduce_grads"]


def _names(ax):
    return ax if isinstance(ax, tuple) else ((ax,) if ax else ())


def sharded_axes(spec: tuple) -> set:
    """The mesh axes a spec shards over."""
    return {n for ax in spec for n in _names(ax)}


def gather_param(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor of ``local`` (this rank's slice under ``spec``),
    differentiable: the gradient of the full tensor is reduce-scattered
    back to the slice."""
    out = local
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    for d, ax in enumerate(spec):
        for name in reversed(_names(ax)):  # the minor axis first
            # A size-1 axis holds the whole dim; fsdp's gather runs even on
            # one rank, so a world of one takes the same collectives.
            if sizes[name] > 1 or name == "fsdp":
                out = gather_shards(out, d, mesh.get_group(name))
    return out


class ShardedLayers:
    """Stacked ``[L, ...]`` layer slices whose layers are gathered one at a
    time by :meth:`unstack` (what ``models/llama.py::unstack_layers``
    iterates)."""

    def __init__(self, local: Dict[str, torch.Tensor], specs: Dict[str, tuple], mesh):
        self.local, self.specs, self.mesh = local, specs, mesh

    def unstack(self) -> Iterator[Dict[str, Any]]:
        per = {k: v.unbind(0) for k, v in self.local.items()}
        L = len(next(iter(per.values())))
        for i in range(L):
            yield {k: gather_param(per[k][i], tuple(self.specs[k][1:]), self.mesh)
                   for k in self.local}


def forward_tree(local: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The parameter tree a Llama-family forward takes: every top-level
    leaf gathered whole, the ``layers`` as :class:`ShardedLayers`."""
    out = {}
    for k, v in local.items():
        if k == "layers":
            out[k] = ShardedLayers(v, specs[k], mesh)
        else:
            out[k] = gather_param(v, specs[k], mesh)
    return out


def reduce_grads(grads: Dict[str, torch.Tensor], specs: Dict[str, tuple], mesh, data_group,
                 fsdp: str = "fsdp") -> None:
    """Sum each gradient over the data ranks, in place: a slice gathered
    over ``fsdp`` was already summed there by the reduce-scatter, so it is
    summed over ``dp``; a replicated leaf over the whole data group."""
    for path, g in grads.items():
        if fsdp in sharded_axes(specs[path]):
            dist.all_reduce(g, group=mesh.get_group("dp"))
        else:
            dist.all_reduce(g, group=data_group)
