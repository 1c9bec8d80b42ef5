"""Quantized matmuls (counterpart of ``llm_fp8_tpu/quant/dot.py``).

Inference (``qdot``): the JAX package's default route on the TPU is XLA's
convert+dot, where XLA fuses the e4m3→bf16 convert into the operand read.
PyTorch has no such fusion: ``w.to(bf16)`` then ``matmul`` would write a bf16
copy of every weight and read it back. So every fp8/int8 QTensor goes
through K1 (:func:`..kernels.quant_matmul.qdot_fused`), the counterpart of
the JAX ``"fused"`` route.

Training (``fp8_dot``): a ``torch.autograd.Function`` with the JAX
``custom_vjp``'s forward and backward. Forward operands are quantized to the
recipe's forward format with delayed scales passed in; the residuals are
kept quantized; the backward quantizes the gradient just in time in the
backward format. The backward's amax leaves through the gradient of a zero
scalar ``amax_sink`` (which must require a gradient), so delayed state for
gradients needs no mutable buffer.

Routes, chosen per call from the recipe and ``LLM_FP8_NATIVE_DOT`` (read
per call, where JAX reads it when it traces). Per-channel quantizes of 2-D
and last-axis operands always go through K9: its plain version stores the
codes and scales of ``quantize`` bit for bit, so the JAX package's
``LLM_FP8_QUANTIZE`` switch would choose only between two speeds here.

* the semantics route: quantize, dequantize to bf16, a bf16 product with a
  float32 accumulator (MX ``block32`` for the mxfp8 set);
* ``"fp8"``: e4m3/e5m2 codes multiplied natively (``torch._scaled_mm`` on
  the card with unit scales and a float32 output; the scales are applied
  after, as ``_narrow_dot``). cuBLASLt wants a row-major first and a
  column-major second operand, so the forward copies the stored ``[K, N]``
  weight codes to column-major and dw copies ``x8ᵀ`` and the gradient
  codes; dx reads the stored codes as they are. One-byte copies;
* ``"int"``: int8 codes (``torch._int_mm`` on the card), for ``int8_train``.

On the CPU the narrow routes multiply the codes in float32, as XLA's CPU dot
does with narrow operands.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from ..kernels.quant_matmul import qdot_fused
from .qtensor import MX_BLOCK, QTensor, quantize, quantize_mx
from .recipe import Recipe

__all__ = ["qdot", "fp8_dot", "DotAmaxes", "matmul_f32"]


class DotAmaxes(NamedTuple):
    """Amax observations from one quantized dot, fed back into delayed
    state. ``g`` is zero in the forward's output; the backward amax leaves
    through the sink's gradient."""

    x: torch.Tensor
    w: torch.Tensor
    g: torch.Tensor


def _scale_is_post_applicable(w: QTensor) -> bool:
    return w.scale.ndim == 0 or all(d == 1 for d in w.scale.shape[:-1])


def qdot(x: torch.Tensor, w: QTensor, *, out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with ``w`` stored quantized (fp8 or int8,
    unpacked; per-tensor, per-channel or MX scales)."""
    if w.pack_axis is not None:
        raise NotImplementedError("qdot: int4 (packed) weights are not ported yet")
    if w.block_size is None and not _scale_is_post_applicable(w):
        raise NotImplementedError("qdot: group-wise scales are not ported yet")
    return qdot_fused(x, w, out_dtype=out_dtype or x.dtype)


# --------------------------------------------------------------------------
# Plain products
# --------------------------------------------------------------------------


class _MatmulF32(torch.autograd.Function):
    """``torch.mm(..., out_dtype=float32)`` has no autograd formula; this
    gives it the JAX transpose of a ``preferred_element_type=float32`` dot:
    gradients in the operands' dtypes. On the card the float32 output
    gradient is rounded to bf16 for the two bf16 products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if g.is_cuda:
            gb = g.to(torch.bfloat16)
            return (gb @ b.t()).to(a.dtype), (a.t() @ gb).to(b.dtype)
        return (g @ b.float().t()).to(a.dtype), (a.float().t() @ g).to(b.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of bf16 operands with a float32 output (the
    JAX package's ``preferred_element_type=float32``): one cuBLAS call on the
    card, a float32 product of the bf16 values on the CPU. Differentiable."""
    return _MatmulF32.apply(a, b)


# --------------------------------------------------------------------------
# Training path: quantize-both-operands dot with a custom backward.
# --------------------------------------------------------------------------

_FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _quantize_channel(t: torch.Tensor, fmt, contract_axis: int, margin: int) -> QTensor:
    """Per-channel quantize through K9 (rows of the last axis, or columns of
    a 2-D operand). The TPU's VMEM size guards are not carried over: K9
    takes any length."""
    from ..kernels.quantize import quantize_fused  # kernels.quantize imports quant

    if contract_axis == t.ndim - 1:
        q = quantize_fused(t.reshape(-1, t.shape[-1]), fmt, axis=-1, margin=margin)
        return QTensor(qvalue=q.qvalue.reshape(t.shape),
                       scale=q.scale.reshape(*t.shape[:-1], 1), fmt=fmt)
    if t.ndim == 2 and contract_axis == 0:
        return quantize_fused(t, fmt, axis=0, margin=margin)
    return quantize(t, fmt, axes=(contract_axis,), margin=margin)


def _q_fwd(t: torch.Tensor, recipe: Recipe, scale, contract_axis: int) -> QTensor:
    """Quantize a forward operand according to the recipe granularity."""
    if recipe.granularity == "block32":
        return quantize_mx(t, recipe.fmt_fwd, block_axis=contract_axis, block_size=MX_BLOCK)
    if recipe.granularity == "channel":
        return _quantize_channel(t, recipe.fmt_fwd, contract_axis, recipe.margin)
    return quantize(t, recipe.fmt_fwd, axes=None, scale=scale, margin=recipe.margin)


def _q_bwd(g: torch.Tensor, recipe: Recipe, contract_axis: int) -> QTensor:
    """Quantize a gradient: just-in-time scale in the backward format."""
    if recipe.granularity == "block32" and g.shape[contract_axis] % MX_BLOCK == 0:
        return quantize_mx(g, recipe.fmt_bwd, block_axis=contract_axis, block_size=MX_BLOCK)
    if recipe.granularity == "channel":
        return _quantize_channel(g, recipe.fmt_bwd, contract_axis, recipe.margin)
    return quantize(g, recipe.fmt_bwd, axes=None, margin=recipe.margin)


def _mx_or_tensor(t: torch.Tensor, fmt, block_axis: int) -> QTensor:
    if t.shape[block_axis] % MX_BLOCK == 0:
        return quantize_mx(t, fmt, block_axis=block_axis, block_size=MX_BLOCK)
    return quantize(t, fmt)


def _native_fp8_enabled() -> bool:
    """``LLM_FP8_NATIVE_DOT=1|0`` decides; unset, the card's capability
    (:func:`..utils.backend.native_fp8_matmul`)."""
    env = os.environ.get("LLM_FP8_NATIVE_DOT")
    if env is not None:
        return env == "1"
    from ..utils.backend import native_fp8_matmul

    return native_fp8_matmul()


def _native_mode(recipe: Recipe) -> Optional[str]:
    """``"int"``, ``"fp8"`` or ``None`` (the semantics route): the narrow
    routes need scales constant along the contraction and quantized
    activations on both passes."""
    if not (recipe.quantize_activations and recipe.granularity in ("tensor", "channel")):
        return None
    if recipe.fmt_fwd.is_integer and recipe.fmt_bwd.is_integer:
        return "int"
    if (recipe.fmt_fwd.dtype in _FP8_DTYPES and recipe.fmt_bwd.dtype in _FP8_DTYPES
            and _native_fp8_enabled()):
        return "fp8"
    return None


def _codes_mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of one-byte codes, accumulated in float32
    (``"fp8"``) or int32 (``"int"``), returned as float32. ``b`` may be any
    view (a transpose included); the card's products get the layouts
    cuBLASLt takes."""
    if not a.is_cuda:
        return a.float() @ b.float()
    if mode == "int":
        return torch._int_mm(a.contiguous(), b.contiguous()).float()
    if a.stride(-1) != 1:
        a = a.contiguous()
    if b.stride(0) != 1:  # column-major second operand
        b = b.t().contiguous().t()
    one = torch.ones((), dtype=torch.float32, device=a.device)
    try:
        return torch._scaled_mm(a, b, one, one, out_dtype=torch.float32)
    except RuntimeError as e:
        raise RuntimeError(f"fp8 matmul of {a.dtype} x {b.dtype} with a float32 output "
                           f"was refused: {e}") from e


def _narrow_dot(aq: QTensor, bq: QTensor, out_dtype, mode: str) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` with narrow operands, scales after: both
    scales are constant along the contraction, so they post-apply exactly."""
    a = aq.qvalue.reshape(-1, aq.qvalue.shape[-1])
    acc = _codes_mm(a, bq.qvalue, mode).reshape(*aq.qvalue.shape[:-1], bq.qvalue.shape[-1])
    y = acc * aq.scale.float() * bq.scale.float().reshape(-1)
    return y.to(out_dtype)


def _amax_of(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().abs().amax()


def _bf16_dot(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """bf16 operands, float32 accumulation, cast to ``out_dtype``."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and out_dtype == torch.bfloat16:
        y = a2 @ b
    else:
        y = matmul_f32(a2, b)
    return y.reshape(*a.shape[:-1], b.shape[-1]).to(out_dtype)


class _Fp8Dot(torch.autograd.Function):
    """``fp8_dot`` with the JAX ``custom_vjp``'s rules (``_fp8_dot_fwd``,
    ``_fp8_dot_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, x_scale, w_scale, amax_sink, recipe: Recipe):
        x_amax, w_amax = _amax_of(x), _amax_of(w)
        wq = _q_fwd(w.detach(), recipe, w_scale, contract_axis=0)
        x_res = (_q_fwd(x.detach(), recipe, x_scale, contract_axis=x.ndim - 1)
                 if recipe.quantize_activations else x.detach())
        mode = _native_mode(recipe)
        if mode:
            y = _narrow_dot(x_res, wq, x.dtype, mode)
        else:
            xv = (x_res.dequantize(torch.bfloat16) if isinstance(x_res, QTensor)
                  else x_res.to(torch.bfloat16))
            y = _bf16_dot(xv, wq.dequantize(torch.bfloat16), x.dtype)
        ctx.recipe, ctx.mode = recipe, mode
        ctx.x_res, ctx.wq = x_res, wq
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        ctx.mark_non_differentiable(x_amax, w_amax, zero)
        return y, x_amax, w_amax, zero

    @staticmethod
    def backward(ctx, gy, *_amax_grads):
        recipe, mode, x_res, wq = ctx.recipe, ctx.mode, ctx.x_res, ctx.wq
        g_amax = _amax_of(gy)
        if mode:
            # Scale folding: the residual's per-channel scale varies along the
            # backward contraction, so it folds into the gradient before the
            # gradient is quantized (JAX quant/dot.py:462-499).
            gy32 = gy.float()
            g_dx = gy32 * wq.scale.float().reshape(-1)
            gq_dx = _quantize_channel(g_dx, recipe.fmt_bwd, g_dx.ndim - 1, recipe.margin)
            g2 = gq_dx.qvalue.reshape(-1, gq_dx.qvalue.shape[-1])
            acc = _codes_mm(g2, wq.qvalue.t(), mode).reshape(*gy.shape[:-1], -1)
            dx = (acc * gq_dx.scale.float()).to(ctx.x_dtype)

            x8 = x_res.qvalue.reshape(-1, x_res.shape[-1])
            g_dw = (gy32 * x_res.scale.float()).reshape(-1, gy.shape[-1])
            gq_dw = _quantize_channel(g_dw, recipe.fmt_bwd, 0, recipe.margin)
            acc = _codes_mm(x8.t(), gq_dw.qvalue, mode)
            dw = (acc * gq_dw.scale.float().reshape(-1)).to(ctx.w_dtype)
            return dx, dw, None, None, g_amax, None

        xv = (x_res.dequantize(torch.bfloat16) if isinstance(x_res, QTensor)
              else x_res.to(torch.bfloat16))
        wv = wq.dequantize(torch.bfloat16)
        # dx = g @ wᵀ: the gradient quantizes along its last axis; the block
        # recipe requantizes w transposed (TE keeps both orientations).
        gq_for_dx = _q_bwd(gy, recipe, contract_axis=gy.ndim - 1)
        if recipe.granularity == "block32":
            wT = _mx_or_tensor(wv.t().float(), recipe.fmt_bwd, block_axis=1).dequantize(
                torch.bfloat16)
        else:
            wT = wv.t()
        dx = _bf16_dot(gq_for_dx.dequantize(torch.bfloat16), wT, ctx.x_dtype)
        # dw = xᵀ @ g: contraction over the batch rows.
        x2 = xv.reshape(-1, xv.shape[-1])
        g2 = gy.reshape(-1, gy.shape[-1]).float()
        gq_for_dw = _q_bwd(g2, recipe, contract_axis=0)
        if recipe.granularity == "block32":
            xT = _mx_or_tensor(x2.t().float(), recipe.fmt_bwd, block_axis=1).dequantize(
                torch.bfloat16)
        else:
            xT = x2.t()
        dw = _bf16_dot(xT, gq_for_dw.dequantize(torch.bfloat16), ctx.w_dtype)
        return dx, dw, None, None, g_amax, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor, x_scale, w_scale, amax_sink: torch.Tensor,
            recipe: Recipe):
    """FP8 training matmul: ``x [B, K] @ w [K, N] -> ([B, N], DotAmaxes)``.

    ``x_scale`` / ``w_scale`` are delayed scales (0-d tensors) from
    :class:`~.delayed.ScaleState`, or ``None`` for just-in-time scaling.
    ``amax_sink`` is a zero 0-d float32 tensor that requires a gradient; after
    ``backward`` its gradient is the amax of this dot's output gradient.
    """
    y, x_amax, w_amax, g = _Fp8Dot.apply(x, w, x_scale, w_scale, amax_sink, recipe)
    return y, DotAmaxes(x=x_amax, w=w_amax, g=g)
