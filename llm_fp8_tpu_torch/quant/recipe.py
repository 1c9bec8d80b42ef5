"""FP8 recipes as data (counterpart of ``llm_fp8_tpu/quant/recipe.py``).

The reference implements its three recipes as TE recipe *objects* applied via
``fp8_autocast`` context managers, with the layer-wise assignment expressed by
opening two different scopes per decoder layer (attention under HYBRID, MLP
under E4M3 — reference ``te_llama.py:39-40,76-81``). Here a recipe is a frozen
dataclass and the layer-wise assignment is a declarative table mapping module
roles to recipes; the model code looks its recipe up by role, nothing is
context-dependent.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional

from .formats import Format, E4M3, E5M2, INT8, INT4

__all__ = [
    "Recipe",
    "RecipeSet",
    "DELAYED_E4M3",
    "DELAYED_HYBRID",
    "MXFP8",
    "LAYERWISE",
    "UNIFORM_HYBRID",
    "MXFP8_SET",
    "INT8_WEIGHTS",
    "INT4_WEIGHTS",
    "INT8_TRAIN",
    "BF16_SET",
    "recipe_set_by_name",
]

Granularity = Literal["tensor", "channel", "block32"]


@dataclasses.dataclass(frozen=True)
class Recipe:
    """How one tensor class (weights / activations / gradients) is quantized.

    ``fmt_fwd`` applies to forward tensors (weights, activations), ``fmt_bwd``
    to gradients flowing in the backward pass — the E4M3/E5M2 split is TE's
    ``Format.HYBRID`` (reference ``te_llama_hybrid.py:39``).
    Delayed-scaling knobs mirror ``train_fp8.py:159-165``:
    ``amax_history_len=16, amax_compute='max', margin=0``.
    """

    granularity: Granularity = "tensor"
    fmt_fwd: Format = E4M3
    fmt_bwd: Format = E5M2
    amax_history_len: int = 16
    amax_compute: Literal["max", "most_recent"] = "max"
    margin: int = 0
    # Quantize activations (not just weights). Weight-only FP8 is the
    # bandwidth-bound serving recipe; weights+activations is the training one.
    quantize_activations: bool = True
    # Per-group weight scales along the contraction (channel granularity
    # only): the standard int4 serving granularity. None = one scale per
    # output channel.
    group_size: Optional[int] = None

    def with_(self, **kw) -> "Recipe":
        return dataclasses.replace(self, **kw)


#: TE ``DelayedScaling(fp8_format=E4M3)`` — everything e4m3, incl. gradients.
DELAYED_E4M3 = Recipe(fmt_fwd=E4M3, fmt_bwd=E4M3)

#: TE ``DelayedScaling(fp8_format=HYBRID)`` — e4m3 fwd, e5m2 grads.
DELAYED_HYBRID = Recipe(fmt_fwd=E4M3, fmt_bwd=E5M2)

#: TE ``MXFP8BlockScaling(fp8_format=E4M3)`` — 32-elem power-of-two blocks.
MXFP8 = Recipe(granularity="block32", fmt_fwd=E4M3, fmt_bwd=E4M3)


@dataclasses.dataclass(frozen=True)
class RecipeSet:
    """Maps module roles to recipes; ``None`` role entry = keep high precision.

    Roles used by the model layer: ``attn_qkv``, ``attn_out``, ``mlp``,
    ``kv_cache``, ``lm_head``, ``embed``. ``default`` covers unlisted roles.
    """

    name: str
    default: Optional[Recipe]
    overrides: Dict[str, Optional[Recipe]] = dataclasses.field(default_factory=dict)

    def for_role(self, role: str) -> Optional[Recipe]:
        if role in self.overrides:
            return self.overrides[role]
        return self.default

    @property
    def enabled(self) -> bool:
        return self.default is not None or any(
            r is not None for r in self.overrides.values()
        )


# The paper's layer-wise assignment ("our fp8 method", te_llama.py:39-40):
# attention under HYBRID delayed scaling, MLP under pure-E4M3 delayed scaling.
# Embeddings and the LM head stay high precision (TE never wraps them either).
LAYERWISE = RecipeSet(
    name="layerwise",
    default=None,
    overrides={
        "attn_qkv": DELAYED_HYBRID,
        "attn_out": DELAYED_HYBRID,
        "mlp": DELAYED_E4M3,
        "kv_cache": DELAYED_E4M3,
    },
)

#: Uniform HYBRID delayed scaling on every matmul (te_llama_hybrid.py:39).
UNIFORM_HYBRID = RecipeSet(
    name="hybrid",
    default=None,
    overrides={
        "attn_qkv": DELAYED_HYBRID,
        "attn_out": DELAYED_HYBRID,
        "mlp": DELAYED_HYBRID,
        "kv_cache": DELAYED_HYBRID,
    },
)

#: MXFP8 block scaling on every matmul (te_llama_mxfp8.py:28-29).
MXFP8_SET = RecipeSet(
    name="mxfp8",
    default=None,
    overrides={
        "attn_qkv": MXFP8,
        "attn_out": MXFP8,
        "mlp": MXFP8,
        "kv_cache": DELAYED_E4M3,
    },
)

#: Weight-only symmetric int8, per-output-channel scales — the v5e-native
#: serving recipe (no fp8 MXU there; the int8→bf16 convert is hardware,
#: docs/PERF_NOTES.md). Same role as the thesis's FP8-weight vLLM format
#: (thesis/chapters/c3/c3_methodology.tex:46-52) on int8-native hardware.
#: KV cache stays bf16 (the measured-winning cache dtype on v5e).
_INT8_W = Recipe(granularity="channel", fmt_fwd=INT8, fmt_bwd=E5M2,
                 quantize_activations=False)
INT8_WEIGHTS = RecipeSet(
    name="int8",
    default=None,
    overrides={
        "attn_qkv": _INT8_W,
        "attn_out": _INT8_W,
        "mlp": _INT8_W,
    },
)

#: Weight-only symmetric int4, nibble-packed two-per-byte, per-output-channel
#: scales — the capacity-maximal serving recipe: weight bytes halve again vs
#: int8, which in the weight-read-bound decode regime is both less HBM
#: traffic per step and more batch at equal footprint. Unpack is two VPU
#: shifts feeding the hardware int8→bf16 convert (formats.py::INT4). Coarser
#: than int8 (15 levels per channel) — use where int8 accuracy headroom
#: allows, or with group-wise finetuning upstream.
_INT4_W = Recipe(granularity="channel", fmt_fwd=INT4, fmt_bwd=E5M2,
                 quantize_activations=False, group_size=128)
INT4_WEIGHTS = RecipeSet(
    name="int4",
    default=None,
    overrides={
        "attn_qkv": _INT4_W,
        "attn_out": _INT4_W,
        "mlp": _INT4_W,
    },
)

#: Per-channel symmetric int8 on BOTH operands of every matmul, forward and
#: backward — the TPU-native precision-accelerated *training* recipe. On
#: v5e-class parts the MXU executes int8×int8→int32 at ~2× its bf16 FLOP
#: rate, so these GEMMs run on the fast path the way the reference's FP8
#: GEMMs ride H100 fp8 tensor cores (``paper/conference_101719.tex:247``) —
#: fp8 cannot do that on v5e (no fp8 MXU; dequant is VPU software). Scales
#: are just-in-time per-channel (constant along the contraction), applied
#: exactly after the int32 accumulation (quant/dot.py::_int_dot).
_INT8_T = Recipe(granularity="channel", fmt_fwd=INT8, fmt_bwd=INT8,
                 quantize_activations=True)
INT8_TRAIN = RecipeSet(
    name="int8_train",
    default=None,
    overrides={
        "attn_qkv": _INT8_T,
        "attn_out": _INT8_T,
        "mlp": _INT8_T,
    },
)

#: No quantization anywhere — the bf16 baseline.
BF16_SET = RecipeSet(name="bf16", default=None, overrides={})

_SETS = {s.name: s for s in (LAYERWISE, UNIFORM_HYBRID, MXFP8_SET,
                             INT8_WEIGHTS, INT4_WEIGHTS, INT8_TRAIN,
                             BF16_SET)}
# CLI-compatible aliases: the reference calls the layer-wise recipe "default"
# (fp8_scenario ∈ {default, mxfp8, hybrid}, train_fp8.py:103-116).
_SETS["default"] = LAYERWISE


def recipe_set_by_name(name: str) -> RecipeSet:
    try:
        return _SETS[name]
    except KeyError:
        raise ValueError(f"unknown recipe set {name!r}; known: {sorted(_SETS)}")
