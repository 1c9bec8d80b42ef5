"""ViT-class vision encoder: patchify, [CLS] and learned positions, a pre-LN
transformer (counterpart of ``llm_fp8_tpu/models/vit.py``; the registry is a
copy).

The patch embedding is a convolution whose stride is its kernel, so it is a
reshape (:func:`patchify`, no convolution) and one ``[C·p·p, D]`` product.
Parameters keep the JAX package's stacked layout (weights are tensors or
:class:`~..quant.QTensor`). The forward computes in float32 by default: on
the card its attention is K3's float32 instance, non-causal, over ``1 +
num_patches`` rows (197 at 224/16); debug-vit's head dim 16 runs zero-padded
onto the 32 instance (``kernels/_common.py::PADDED_HEAD_DIMS``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..ops.attention import attention
from ..ops.layernorm import layernorm
from ..utils.backend import resolve_device
from .bert import encoder_attn_impl, gelu_f32
from .llama import _dot, unstack_layers
from .zoo import stacker, state_getter

__all__ = ["ViTConfig", "VIT_REGISTRY", "init_vit_params", "vit_forward",
           "pack_vit_state_dict", "patchify"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    ln_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.patch_size ** 2


VIT_REGISTRY = {
    "vit-base-patch16-224": ViTConfig(name="vit-base-patch16-224"),
    "vit-large-patch16-224": ViTConfig(
        name="vit-large-patch16-224", hidden_size=1024,
        intermediate_size=4096, num_layers=24, num_heads=16),
    "debug-vit": ViTConfig(name="debug-vit", image_size=32, patch_size=8,
                           hidden_size=64, intermediate_size=128,
                           num_layers=2, num_heads=4),
}


def init_vit_params(cfg: ViTConfig, generator: Optional[torch.Generator] = None, *,
                    dtype=torch.float32, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02) (positions 0.01), drawn on ``device``
    from ``generator`` (a new one seeded with ``seed`` when none is given);
    norms 1, biases 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * std).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "patch_w": w(cfg.patch_dim, D),
        "patch_b": full(0.0, D),
        "cls": w(1, 1, D),
        "pos": w(1, cfg.num_patches + 1, D, std=0.01),
        "layers": {
            "ln1_w": full(1.0, L, D), "ln1_b": full(0.0, L, D),
            "ln2_w": full(1.0, L, D), "ln2_b": full(0.0, L, D),
            "w_qkv": w(L, D, 3 * D),
            "b_qkv": full(0.0, L, 3 * D),
            "w_out": w(L, D, D),
            "b_out": full(0.0, L, D),
            "w_fc": w(L, D, I),
            "b_fc": full(0.0, L, I),
            "w_proj": w(L, I, D),
            "b_proj": full(0.0, L, D),
        },
        "lnf_w": full(1.0, D),
        "lnf_b": full(0.0, D),
    }


def pack_vit_state_dict(sd, cfg: ViTConfig, dtype=torch.float32, device=None):
    """HF ``ViTModel`` state dict → stacked params. The patch convolution's
    kernel ``[D, C, p, p]`` flattens in ``(C, ph, pw)`` order to the ``[C·p·p,
    D]`` product weight; the q/k/v Linears ``[out, in]`` concatenate
    transposed."""
    g = state_getter(sd, dtype, device)
    L = cfg.num_layers
    pre = "encoder.layer.{}."
    stack = stacker(g, L)

    def qkv(i, kind):
        p = pre.format(i) + "attention.attention."
        parts = [g(p + f"{n}.{kind}") for n in ("query", "key", "value")]
        return torch.cat([t.t() for t in parts], dim=1) if kind == "weight" else torch.cat(parts)

    conv = g("embeddings.patch_embeddings.projection.weight")
    return {
        "patch_w": conv.reshape(cfg.hidden_size, cfg.patch_dim).t(),
        "patch_b": g("embeddings.patch_embeddings.projection.bias"),
        "cls": g("embeddings.cls_token"),
        "pos": g("embeddings.position_embeddings"),
        "layers": {
            "ln1_w": stack(pre + "layernorm_before.weight"),
            "ln1_b": stack(pre + "layernorm_before.bias"),
            "ln2_w": stack(pre + "layernorm_after.weight"),
            "ln2_b": stack(pre + "layernorm_after.bias"),
            "w_qkv": torch.stack([qkv(i, "weight") for i in range(L)]),
            "b_qkv": torch.stack([qkv(i, "bias") for i in range(L)]),
            "w_out": stack(pre + "attention.output.dense.weight", tr=True),
            "b_out": stack(pre + "attention.output.dense.bias"),
            "w_fc": stack(pre + "intermediate.dense.weight", tr=True),
            "b_fc": stack(pre + "intermediate.dense.bias"),
            "w_proj": stack(pre + "output.dense.weight", tr=True),
            "b_proj": stack(pre + "output.dense.bias"),
        },
        "lnf_w": g("layernorm.weight"),
        "lnf_b": g("layernorm.bias"),
    }


def patchify(pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """``[B, C, H, W]`` → ``[B, num_patches, C·p·p]``, each patch flattened in
    the convolution kernel's ``(C, ph, pw)`` order: a reshape."""
    B, C, H, W = pixels.shape
    p = cfg.patch_size
    x = pixels.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // p) * (W // p), C * p * p)


def vit_forward(params: Dict[str, Any], pixels: torch.Tensor, cfg: ViTConfig, *,
                attn_impl: str = "auto", compute_dtype=torch.float32) -> torch.Tensor:
    """``pixels [B, C, H, W]`` → the last hidden state ``[B, 1 +
    num_patches, D]`` after the final LayerNorm (HF ``ViTModel`` without its
    pooler); row 0 is [CLS]."""
    encoder_attn_impl(attn_impl)
    dev = params["lnf_w"].device
    pixels = pixels.to(dev)
    B = pixels.shape[0]
    D, H, Dh = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    x = _dot(patchify(pixels.to(compute_dtype), cfg), params["patch_w"])
    x = x + params["patch_b"].to(x.dtype)
    cls = params["cls"].to(x.dtype).expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype)
    S = x.shape[1]
    for lp in unstack_layers(params["layers"]):
        h = layernorm(x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        qkv = _dot(h, lp["w_qkv"]) + lp["b_qkv"].to(x.dtype)
        q, k, v = (t.reshape(B, S, H, Dh) for t in torch.split(qkv, D, dim=-1))
        a = attention(q, k, v, causal=False)
        x = x + _dot(a.reshape(B, S, D), lp["w_out"]) + lp["b_out"].to(x.dtype)
        h = layernorm(x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        h = gelu_f32(_dot(h, lp["w_fc"]) + lp["b_fc"].to(x.dtype))
        x = x + _dot(h, lp["w_proj"]) + lp["b_proj"].to(x.dtype)
    return layernorm(x, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
