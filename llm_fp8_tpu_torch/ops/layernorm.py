"""LayerNorm with bias (counterpart of ``llm_fp8_tpu/ops/layernorm.py``),
for the GPT-2 and NeoX families. The JAX package leaves it to XLA, so plain
PyTorch is its port."""
from __future__ import annotations

import torch

__all__ = ["layernorm"]


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * weight + bias``: mean and variance in
    float32, the result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)
