"""FP8 formats, quantized tensors, recipes, delayed scaling and the matmuls."""
from .formats import E4M3, E5M2, INT4, INT8, Format, format_by_name
from .qtensor import MX_BLOCK, QTensor, compute_scale, dequantize, quantize, quantize_mx
from .recipe import (BF16_SET, DELAYED_E4M3, DELAYED_HYBRID, INT4_WEIGHTS, INT8_TRAIN,
                     INT8_WEIGHTS, LAYERWISE, MXFP8, MXFP8_SET, UNIFORM_HYBRID, Recipe,
                     RecipeSet, recipe_set_by_name)
from .delayed import ScaleState, current_scale, init_scale_state, observe_amax
from .dot import DotAmaxes, fp8_dot, qdot

__all__ = [
    "Format", "E4M3", "E5M2", "INT8", "INT4", "format_by_name",
    "QTensor", "quantize", "quantize_mx", "dequantize", "compute_scale", "MX_BLOCK",
    "Recipe", "RecipeSet", "LAYERWISE", "UNIFORM_HYBRID", "MXFP8_SET",
    "INT8_WEIGHTS", "INT4_WEIGHTS", "BF16_SET", "recipe_set_by_name", "qdot",
    "DELAYED_E4M3", "DELAYED_HYBRID", "MXFP8", "INT8_TRAIN",
    "ScaleState", "init_scale_state", "observe_amax", "current_scale",
    "fp8_dot", "DotAmaxes",
]
