"""FP8 formats, quantized tensors, recipes and the inference matmul."""
from .formats import E4M3, E5M2, INT4, INT8, Format, format_by_name
from .qtensor import MX_BLOCK, QTensor, compute_scale, dequantize, quantize, quantize_mx
from .recipe import (BF16_SET, INT4_WEIGHTS, INT8_WEIGHTS, LAYERWISE, MXFP8_SET,
                     UNIFORM_HYBRID, Recipe, RecipeSet, recipe_set_by_name)
from .dot import qdot

__all__ = [
    "Format", "E4M3", "E5M2", "INT8", "INT4", "format_by_name",
    "QTensor", "quantize", "quantize_mx", "dequantize", "compute_scale", "MX_BLOCK",
    "Recipe", "RecipeSet", "LAYERWISE", "UNIFORM_HYBRID", "MXFP8_SET",
    "INT8_WEIGHTS", "INT4_WEIGHTS", "BF16_SET", "recipe_set_by_name", "qdot",
]
