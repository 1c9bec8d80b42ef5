"""One name → (config, init, forward, quantize) across the model families
(counterpart of ``llm_fp8_tpu/models/registry.py``): the entry point the
serving CLI and ``Engine(forward_fn=...)`` use to drive any ported family.

Ported: the Llama family (``models/config.py``), GPT-2 (``models/gpt2.py``),
NeoX (``models/neox.py``), Gemma-2 (``models/gemma.py``, quantized by the
Llama family's ``quantize_params``, as in JAX: its GEMM leaves have the same
names), the MoE family (``models/moe.py``: Mixtral and Qwen3-MoE, quantized
by ``quantize_moe_params``) and the MLA family (``models/mla.py``:
DeepSeek-V2-Lite and DeepSeek-V2, quantized by ``quantize_mla_params``).
Every family of the JAX package's registry is ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from ..quant import RecipeSet, quantize, quantize_mx
from ..quant.dot import serving_layout

__all__ = ["ZooEntry", "resolve_model", "zoo_model_names", "quantize_zoo_params",
           "load_zoo_checkpoint", "UNPORTED_FAMILIES"]


class ZooEntry(NamedTuple):
    cfg: Any
    init_fn: Callable
    forward_fn: Callable
    quantize_fn: Callable  # (params, RecipeSet) -> params


#: The GPT-2 and NeoX families' stacked GEMM leaves → recipe-set roles (the
#: role split of the Llama family's ``quantize_params``).
_ZOO_SITES = {"w_qkv": "attn_qkv", "w_out": "attn_out", "w_fc": "mlp", "w_proj": "mlp"}

#: The JAX package's families not ported yet, with their registry names:
#: none is left.
UNPORTED_FAMILIES: Dict[str, tuple] = {}


def quantize_zoo_params(params: Dict[str, Any], recipes: RecipeSet,
                        sites: Dict[str, str] = _ZOO_SITES) -> Dict[str, Any]:
    """Prequantize a GPT-2/NeoX-family tree's GEMM weights: per-output-channel
    scales on the stacked ``[L, K, N]`` weights (MX blocks for the block
    recipe), subnormal codes flushed, codes laid out for the ``qdot`` route
    in force (``serving_layout``, which also pads K and N to multiples of 16
    for the fp8native route once, here); norms, embeddings, biases and the
    head stay as they are."""
    out = dict(params)
    layers = dict(params["layers"])
    for name, role in sites.items():
        recipe = recipes.for_role(role)
        if recipe is None or name not in layers:
            continue
        wv = layers[name].float()
        if recipe.granularity == "block32":
            layers[name] = quantize_mx(wv, recipe.fmt_fwd, block_axis=1, flush_subnormal=True)
        else:
            layers[name] = serving_layout(quantize(
                wv, recipe.fmt_fwd, axes=(1,), margin=recipe.margin,
                group_size=recipe.group_size, flush_subnormal=True))
    out["layers"] = layers
    return out


def resolve_model(name: str) -> ZooEntry:
    """Look ``name`` up across every ported family's registry."""
    from .config import MODEL_REGISTRY
    from .gemma import GEMMA_REGISTRY, gemma_forward, init_gemma_params
    from .gpt2 import GPT2_REGISTRY, gpt2_forward, init_gpt2_params
    from .llama import forward, init_params, quantize_params
    from .mla import MLA_REGISTRY, init_mla_params, mla_forward, quantize_mla_params
    from .moe import MOE_REGISTRY, init_moe_params, moe_forward, quantize_moe_params
    from .neox import NEOX_REGISTRY, init_neox_params, neox_forward

    if name in MODEL_REGISTRY:
        return ZooEntry(MODEL_REGISTRY[name], init_params, forward, quantize_params)
    if name in GPT2_REGISTRY:
        return ZooEntry(GPT2_REGISTRY[name], init_gpt2_params, gpt2_forward,
                        quantize_zoo_params)
    if name in NEOX_REGISTRY:
        return ZooEntry(NEOX_REGISTRY[name], init_neox_params, neox_forward,
                        quantize_zoo_params)
    if name in GEMMA_REGISTRY:
        return ZooEntry(GEMMA_REGISTRY[name], init_gemma_params, gemma_forward,
                        quantize_params)
    if name in MOE_REGISTRY:
        return ZooEntry(MOE_REGISTRY[name], init_moe_params, moe_forward, quantize_moe_params)
    if name in MLA_REGISTRY:
        return ZooEntry(MLA_REGISTRY[name], init_mla_params, mla_forward, quantize_mla_params)
    raise ValueError(f"unknown model {name!r}; known: {sorted(zoo_model_names())}")


def zoo_model_names() -> list:
    """Every name :func:`resolve_model` resolves."""
    from .config import MODEL_REGISTRY
    from .gemma import GEMMA_REGISTRY
    from .gpt2 import GPT2_REGISTRY
    from .mla import MLA_REGISTRY
    from .moe import MOE_REGISTRY
    from .neox import NEOX_REGISTRY

    return [*MODEL_REGISTRY, *GPT2_REGISTRY, *NEOX_REGISTRY, *GEMMA_REGISTRY, *MOE_REGISTRY,
            *MLA_REGISTRY]


def load_zoo_checkpoint(name: str, path: str, dtype=torch.bfloat16, device=None):
    """An HF safetensors directory (one file or an index of shards, read by
    the port's own reader) → the stacked params of the zoo model ``name``,
    through its family's packer."""
    from .hf_loader import _load_all

    entry = resolve_model(name)
    return _pack_fn_for(name)(_load_all(path), entry.cfg, dtype, device=device)


def _pack_fn_for(name: str) -> Callable:
    """The HF state-dict packer of ``name``'s family (the GPT-2/NeoX flavour
    is read from the registry name's prefix, as in the JAX package; an MoE
    config with QK-norm is Qwen3-MoE, else Mixtral; an MLA config is
    DeepSeek-V2)."""
    from . import gpt2, mla, moe, neox
    from .config import MODEL_REGISTRY
    from .gemma import GEMMA_REGISTRY, pack_gemma2_state_dict
    from .hf_loader import pack_hf_state_dict

    if name in MODEL_REGISTRY:
        return pack_hf_state_dict
    if name in GEMMA_REGISTRY:
        return pack_gemma2_state_dict
    if name in moe.MOE_REGISTRY:
        return (moe.pack_qwen3_moe_state_dict if moe.MOE_REGISTRY[name].qk_norm
                else moe.pack_mixtral_state_dict)
    if name in mla.MLA_REGISTRY:
        return mla.pack_deepseek_state_dict
    by_prefix = [
        ("gpt2", gpt2.pack_gpt2_state_dict),
        ("opt-", gpt2.pack_opt_state_dict),
        ("santacoder", gpt2.pack_bigcode_state_dict),
        ("btlm", gpt2.pack_btlm_state_dict),
        ("pythia", neox.pack_neox_state_dict),
        ("debug-neox", neox.pack_neox_state_dict),
        ("falcon", neox.pack_falcon_state_dict),
        ("debug-falcon", neox.pack_falcon_state_dict),
        ("gptj", neox.pack_gptj_state_dict),
        ("debug-gptj", neox.pack_gptj_state_dict),
        ("debug-gpt2", gpt2.pack_gpt2_state_dict),
        ("debug-opt", gpt2.pack_opt_state_dict),
        ("debug-bigcode", gpt2.pack_bigcode_state_dict),
        ("debug-btlm", gpt2.pack_btlm_state_dict),
    ]
    for prefix, fn in by_prefix:
        if name.startswith(prefix):
            return fn
    raise ValueError(f"no checkpoint packer known for {name!r}")
