"""Distribution over a ``torch.distributed`` world (counterpart of
``llm_fp8_tpu/parallel``): the mesh, the sharding rules as DTensors, the
differentiable collectives, parameter-sharded data parallelism, ring
attention and the GPipe pipeline."""
from .mesh import (AXES, AXIS_CP, AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_TP, MeshConfig,
                   axis_sizes, data_group, init_world, make_mesh)
from .pipeline import forward_pipelined, pipeline_apply, stage_params
from .ring_attention import ring_attention
from .sharding import (activation_spec, adapt_spec, batch_spec, constrain, gather_tree,
                       kv_cache_spec, param_specs, shard_params)

__all__ = [
    "MeshConfig", "make_mesh", "init_world", "axis_sizes", "data_group", "AXES",
    "AXIS_DP", "AXIS_FSDP", "AXIS_PP", "AXIS_CP", "AXIS_EP", "AXIS_TP",
    "param_specs", "shard_params", "gather_tree", "batch_spec", "activation_spec",
    "kv_cache_spec", "constrain", "adapt_spec", "ring_attention",
    "pipeline_apply", "forward_pipelined", "stage_params",
]
