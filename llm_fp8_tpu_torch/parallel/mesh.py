"""Device mesh over a ``torch.distributed`` world (counterpart of
``llm_fp8_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over the slice; here the
mesh is a ``DeviceMesh`` (``init_device_mesh``) over the initialized
process group, one rank a device, with JAX's six axes in JAX's order:

  * ``dp``   data parallel (parameters replicated);
  * ``fsdp`` parameter-sharded data parallel (every weight sharded, gathered
             a layer at a time, its gradient reduce-scattered);
  * ``pp``   pipeline stages (``parallel/pipeline.py``);
  * ``cp``   context parallel: the sequence ring of ``parallel/ring_attention.py``;
  * ``ep``   expert parallel, ``tp`` tensor parallel: their rows of the
             sharding table are ported (``parallel/sharding.py``); the
             serving engine splits the Llama family over ``tp``
             (``parallel/tensor.py``); the trainer refuses both above 1.

A world is started by the launcher (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), NCCL with one card a rank,
gloo for CPU processes (:func:`init_world`). :func:`data_group` is the
flattened ``(dp, fsdp)`` group over which the batch (or the serving
engine's slots) is cut; :func:`tp_group` the ``tp`` group a model's heads,
MLP columns and vocabulary are split over.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["MeshConfig", "make_mesh", "AXES", "AXIS_DP", "AXIS_FSDP", "AXIS_PP", "AXIS_CP",
           "AXIS_EP", "AXIS_TP", "axis_sizes", "data_group", "data_index", "tp_group", "init_world"]

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_PP = "pp"
AXIS_CP = "cp"
AXIS_EP = "ep"
AXIS_TP = "tp"
AXES = (AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_CP, AXIS_EP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees; ``fsdp = -1`` absorbs the devices the other
    axes leave (JAX's ``MeshConfig``)."""

    dp: int = 1
    fsdp: int = -1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        dp, fsdp, pp, cp, ep, tp = (self.dp, self.fsdp, self.pp, self.cp, self.ep, self.tp)
        if fsdp == -1:
            rest = dp * pp * cp * ep * tp
            assert n_devices % rest == 0, (n_devices, dp, pp, cp, ep, tp)
            fsdp = n_devices // rest
        if dp * fsdp * pp * cp * ep * tp != n_devices:
            raise ValueError(f"mesh {dp}x{fsdp}x{pp}x{cp}x{ep}x{tp} != {n_devices} devices")
        return MeshConfig(dp=dp, fsdp=fsdp, pp=pp, cp=cp, ep=ep, tp=tp)

    def shape(self):
        return (self.dp, self.fsdp, self.pp, self.cp, self.ep, self.tp)


def make_mesh(config: MeshConfig = MeshConfig(), device_type: Optional[str] = None):
    """A ``DeviceMesh`` of the initialized world, shaped by ``config``
    (resolved against the world size, which raises on a mismatch), with
    JAX's axis names. ``device_type``: ``"cuda"`` or ``"cpu"``; default
    ``cuda`` under NCCL, else ``cpu``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_world, or "
                           "torch.distributed.init_process_group)")
    cfg = config.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, cfg.shape(), mesh_dim_names=AXES)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh (the pure sharding functions take this)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


_GROUPS: Dict[tuple, object] = {}


def _subgroup(mesh, kind: str, groups):
    """This rank's group among ``groups`` (rank lists covering the world),
    made once per kind and layout of the world's ranks (every rank keys it
    alike, so all make the same groups in the same order)."""
    key = (kind, dist.group.WORLD, tuple(mesh.mesh.shape), tuple(mesh.mesh.flatten().tolist()))
    if key not in _GROUPS:
        mine, _ = dist.new_subgroups_by_enumeration([g.tolist() for g in groups])
        _GROUPS[key] = mine
    return _GROUPS[key]


def data_group(mesh):
    """The process group of this rank's ``(dp, fsdp)`` ranks (JAX's batch
    spec ``P(("dp", "fsdp"))``), ordered as :func:`data_index` counts them;
    None without a mesh."""
    if mesh is None:
        return None
    ranks = mesh.mesh  # [dp, fsdp, pp, cp, ep, tp]
    return _subgroup(mesh, "data", ranks.permute(2, 3, 4, 5, 0, 1).reshape(
        -1, ranks.shape[0] * ranks.shape[1]))


def tp_group(mesh):
    """The process group of this rank's ``tp`` ranks, ordered by their ``tp``
    coordinate; None without a mesh."""
    if mesh is None:
        return None
    ranks = mesh.mesh
    return _subgroup(mesh, "tp", ranks.reshape(-1, ranks.shape[-1]))


def data_index(mesh) -> int:
    """This rank's place among the data ranks: ``dp`` major, ``fsdp`` minor,
    as JAX's batch spec cuts the rows."""
    return (mesh.get_local_rank(AXIS_DP) * axis_sizes(mesh)[AXIS_FSDP]
            + mesh.get_local_rank(AXIS_FSDP))


def init_world(device: Optional[str] = None) -> torch.device:
    """Join the world the launcher describes (torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL
    with ``cuda:LOCAL_RANK`` as this rank's device, or gloo when ``device``
    is ``"cpu"``. Returns the rank's device. Without those variables it
    starts a world of one on ``localhost`` (``MASTER_PORT``, default 29500)."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", 0))
    cpu = device is not None and torch.device(device).type == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", local)
    if not cpu:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
                                **({} if cpu else {"device_id": dev}))
    return dev
