"""Rotary position embeddings (counterpart of ``llm_fp8_tpu/ops/rotary.py``):
the HF rotate-half convention, with llama3, yarn and linear frequency scaling."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["rope_frequencies", "rope_cos_sin", "apply_rope", "rope_attention_scaling"]


def _yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_attention_scaling(scaling: Optional[dict]) -> float:
    """YaRN's post-scale on cos/sin (1.0 for every other rope type)."""
    if scaling is None:
        return 1.0
    if scaling.get("rope_type", scaling.get("type", "llama3")) != "yarn":
        return 1.0
    af = scaling.get("attention_factor")
    if af is not None:
        return float(af)
    factor = float(scaling["factor"])
    mscale, mscale_all = scaling.get("mscale"), scaling.get("mscale_all_dim")
    if mscale and mscale_all:
        return _yarn_mscale(factor, mscale) / _yarn_mscale(factor, mscale_all)
    return _yarn_mscale(factor)


def _yarn_frequencies(head_dim: int, theta: float, s: dict) -> torch.Tensor:
    factor = float(s["factor"])
    beta_fast = float(s.get("beta_fast") or 32)
    beta_slow = float(s.get("beta_slow") or 1)
    orig = s.get("original_max_position_embeddings")
    if orig is None:
        raise ValueError("yarn rope_scaling requires original_max_position_embeddings")
    orig = float(orig)

    def corr_dim(num_rot: float) -> float:
        return (head_dim * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if s.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0.0), min(high, head_dim - 1.0)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (factor * pos_freqs)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32) - low) / (high - low),
                       0.0, 1.0)
    extrap_w = 1.0 - ramp
    return interp * (1.0 - extrap_w) + extrap * extrap_w


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     scaling: Optional[dict] = None) -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` (float32, on the CPU)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    if scaling is None:
        return inv_freq
    rope_type = scaling.get("rope_type", scaling.get("type", "llama3"))
    if rope_type == "default":
        return inv_freq
    if rope_type == "yarn":
        return _yarn_frequencies(head_dim, theta, scaling)
    if rope_type == "linear":
        return inv_freq / float(scaling["factor"])
    if rope_type != "llama3":
        raise ValueError(f"unsupported rope_type {rope_type!r}")
    factor = float(scaling["factor"])
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (orig / wavelen - low) / (high - low)
    return torch.where(
        wavelen > orig / low, inv_freq / factor,
        torch.where(wavelen < orig / high, inv_freq,
                    (1.0 - smooth) * inv_freq / factor + smooth * inv_freq))


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 scaling: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin ``[..., head_dim // 2]`` float32 for integer positions."""
    angles = positions.float()[..., None] * inv_freq.to(positions.device)
    cos, sin = torch.cos(angles), torch.sin(angles)
    f = rope_attention_scaling(scaling)
    if f != 1.0:
        cos, sin = cos * f, sin * f
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [..., seq, heads, head_dim]``, cos/sin ``[..., seq, head_dim // 2]``."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    c, s = cos.unsqueeze(-2), sin.unsqueeze(-2)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
