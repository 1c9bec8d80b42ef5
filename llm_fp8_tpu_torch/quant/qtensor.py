"""QTensor: a quantized tensor plus its scales (counterpart of
``llm_fp8_tpu/quant/qtensor.py``).

Scale convention: ``x ≈ qvalue.float() * spread(scale)``; quantization
divides by the same scale. Stored codes and scales match the JAX package bit
for bit: clip before the cast (e4m3fn has no inf), round int8 half-to-even.

Granularities: per-tensor (``axes=None``), per-axis (one scale per slice
along the kept axes), per-group (float scales over ``group_size`` blocks of
one axis) and MX (one power-of-two scale per 32 elements, stored as bf16).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .formats import E4M3, Format

__all__ = ["QTensor", "quantize", "quantize_mx", "dequantize",
           "compute_scale", "MX_BLOCK"]

MX_BLOCK = 32
_TINY = 1e-12


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Quantized payload + scale.

    ``block_axis``/``pack_axis`` are negative (counted from the trailing
    dims) so that :meth:`layer` can peel a leading stacked-layer axis.
    ``pack_axis`` marks int4 split-half nibble packing.
    """

    qvalue: torch.Tensor
    scale: torch.Tensor
    fmt: Format
    block_size: Optional[int] = None
    block_axis: Optional[int] = None
    pack_axis: Optional[int] = None

    @property
    def shape(self):
        return self.qvalue.shape

    @property
    def dtype(self):
        return self.qvalue.dtype

    @property
    def ndim(self):
        return self.qvalue.ndim

    def spread_scale(self) -> torch.Tensor:
        scale = self.scale.float()
        if self.block_size is None:
            return scale
        return scale.repeat_interleave(self.block_size, dim=self.block_axis)

    def unpack(self) -> torch.Tensor:
        if self.pack_axis is None:
            return self.qvalue
        return _unpack_int4(self.qvalue, self.pack_axis)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.unpack().float() * self.spread_scale()).to(dtype)

    def layer(self, i: int) -> "QTensor":
        """The ``i``-th slice of a stacked ``[L, ...]`` QTensor."""
        return dataclasses.replace(self, qvalue=self.qvalue[i], scale=self.scale[i])

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, qvalue=self.qvalue.to(device),
                                   scale=self.scale.to(device))


def compute_scale(amax: torch.Tensor, fmt: Format, margin: int = 0) -> torch.Tensor:
    """``scale = max(amax, tiny) / fmt.max * 2^margin`` in float32.

    The divisor is a 0-d tensor on ``amax``'s device: on a card PyTorch turns
    a division by a Python float into a multiplication by its reciprocal,
    which rounds differently; this way the card and the CPU (and K9) divide
    alike."""
    amax = torch.clamp(torch.as_tensor(amax, dtype=torch.float32), min=_TINY)
    fmax = torch.full((), fmt.max, dtype=torch.float32, device=amax.device)
    return amax / fmax * (2.0 ** margin)


def _amax(x: torch.Tensor, axes: Optional[Sequence[int]]) -> torch.Tensor:
    a = x.float().abs()
    if axes is None:
        return a.amax()
    return a.amax(dim=tuple(axes), keepdim=True)


def _pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Split-half pack: byte ``i`` holds elements ``i`` (low nibble) and
    ``i + n/2`` (high nibble) along ``axis``."""
    axis = axis % q.ndim
    n = q.shape[axis]
    if n % 2 != 0:
        raise ValueError(f"int4 pack axis {axis} has odd length {n}")
    lo, hi = torch.split(q.to(torch.int32), n // 2, dim=axis)
    return ((lo & 0x0F) | ((hi & 0x0F) << 4)).to(torch.uint8).view(torch.int8)


def _unpack_int4_halves(q: torch.Tensor):
    """The two logical halves of a packed array, each sign-extended."""
    q32 = q.to(torch.int32)
    lo = ((q32 & 0x0F) ^ 0x08) - 0x08
    hi = q32 >> 4
    return lo.to(torch.int8), hi.to(torch.int8)


def _unpack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    lo, hi = _unpack_int4_halves(q)
    return torch.cat([lo, hi], dim=axis % q.ndim)


def _flush_e4m3_subnormal(q: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Round e4m3 subnormal codes (|x| < 2^-6) to +0."""
    if fmt.dtype != torch.float8_e4m3fn:
        return q
    sub = q.float().abs() < 2.0 ** -6
    return torch.where(sub, torch.zeros_like(q), q)


def _cast(q: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Clipped float32 → storage dtype (round half-to-even for integers)."""
    if fmt.is_integer:
        q = torch.round(q)
    return q.to(fmt.dtype)


def quantize(
    x: torch.Tensor,
    fmt: Format = E4M3,
    *,
    axes: Optional[Sequence[int]] = None,
    scale: Optional[torch.Tensor] = None,
    margin: int = 0,
    group_size: Optional[int] = None,
    flush_subnormal: bool = False,
) -> QTensor:
    """Per-tensor (``axes=None``) or per-axis quantization; ``axes`` are the
    axes reduced over for the amax. See the JAX docstring for the meaning of
    ``group_size`` and ``flush_subnormal``."""
    x32 = x.float()
    if (group_size is not None and scale is None and axes is not None
            and len(axes) == 1 and x.shape[axes[0] % x.ndim] % group_size == 0):
        return _quantize_grouped(x32, fmt, axes[0] % x.ndim, group_size, margin)
    if scale is None:
        scale = compute_scale(_amax(x32, axes), fmt, margin)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = _cast(torch.clamp(x32 / scale, -fmt.max, fmt.max), fmt)
    q = _flush_e4m3_subnormal(q, fmt) if flush_subnormal else q
    if scale.ndim == 0:
        scale = scale.reshape((1,) * x.ndim)
    if fmt.name == "int4":
        if axes is None or len(axes) != 1:
            raise ValueError("int4 quantization needs exactly one reduction "
                             "axis (the contraction) to pack along")
        pack_axis = axes[0] % x.ndim
        return QTensor(qvalue=_pack_int4(q, pack_axis), scale=scale, fmt=fmt,
                       pack_axis=pack_axis - x.ndim)
    return QTensor(qvalue=q, scale=scale, fmt=fmt)


def _quantize_grouped(x32: torch.Tensor, fmt: Format, axis: int,
                      group_size: int, margin: int) -> QTensor:
    n = x32.shape[axis]
    xb = x32.reshape(x32.shape[:axis] + (n // group_size, group_size)
                     + x32.shape[axis + 1:])
    scale = compute_scale(xb.abs().amax(dim=axis + 1), fmt, margin)
    q = torch.clamp(xb / scale.unsqueeze(axis + 1), -fmt.max, fmt.max)
    q = _cast(q, fmt).reshape(x32.shape)
    pack_axis = None
    if fmt.name == "int4":
        q = _pack_int4(q, axis)
        pack_axis = axis - x32.ndim
    return QTensor(qvalue=q, scale=scale, fmt=fmt, block_size=group_size,
                   block_axis=axis - x32.ndim, pack_axis=pack_axis)


def quantize_mx(
    x: torch.Tensor,
    fmt: Format = E4M3,
    *,
    block_axis: int = -1,
    block_size: int = MX_BLOCK,
    flush_subnormal: bool = False,
) -> QTensor:
    """OCP MX block quantization: ``shared_exp = floor(log2(amax)) -
    floor(log2(fmt.max))`` per block, scale ``2^shared_exp`` stored as bf16."""
    block_axis = block_axis % x.ndim
    n = x.shape[block_axis]
    if n % block_size != 0:
        raise ValueError(
            f"axis {block_axis} size {n} not divisible by block_size {block_size}")
    x32 = x.float()
    xb = x32.reshape(x.shape[:block_axis] + (n // block_size, block_size)
                     + x.shape[block_axis + 1:])
    amax = xb.abs().amax(dim=block_axis + 1)
    emax_elem = float(torch.floor(torch.log2(torch.tensor(fmt.max, dtype=torch.float32))))
    shared_exp = torch.floor(torch.log2(torch.clamp(amax, min=_TINY))) - emax_elem
    scale = torch.exp2(torch.clamp(shared_exp, -127.0, 127.0))
    q = torch.clamp(xb / scale.unsqueeze(block_axis + 1), -fmt.max, fmt.max)
    q = q.to(fmt.dtype).reshape(x.shape)
    q = _flush_e4m3_subnormal(q, fmt) if flush_subnormal else q
    return QTensor(qvalue=q, scale=scale.to(torch.bfloat16), fmt=fmt,
                   block_size=block_size, block_axis=block_axis - x.ndim)


def dequantize(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    return q.dequantize(dtype)
