"""RMSNorm (counterpart of ``llm_fp8_tpu/ops/rmsnorm.py``)."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm", "rmsnorm_residual"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * weight``, reduction in float32."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5):
    """Residual add + RMSNorm: ``(rmsnorm(x + residual), x + residual)``. The
    sum is rounded to x's dtype before the norm (the fused kernel K8 does not
    round it first)."""
    s = (x.float() + residual.float()).to(x.dtype)
    return rmsnorm(s, weight, eps), s
