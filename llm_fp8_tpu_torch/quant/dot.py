"""Quantized matmuls (counterpart of ``llm_fp8_tpu/quant/dot.py``).

Inference (``qdot``): the reference's routes, chosen as it chooses them
(``impl=``, else ``LLM_FP8_QDOT``, else the default; both read per call):

* ``"fp8native"``, the default for e4m3/e5m2 weights with tensor or channel
  scales where the card multiplies fp8 natively (``LLM_FP8_NATIVE_DOT``,
  else :func:`..utils.backend.native_fp8_matmul`): x is quantized per row
  to e4m3 by K9 and multiplied fp8 by fp8 (``_narrow_dot``,
  ``torch._scaled_mm`` on the card), the scales after. cuBLASLt wants the
  second operand column-major, so :func:`serving_layout` (called by
  ``quantize_params``) stores such weights as the ``.t()`` view of
  contiguous ``[N, K]`` codes: ``qvalue`` stays logically ``[K, N]`` and no
  call copies it. A one-time notice says the route was picked.
* ``"fused"``: K1 (:func:`..kernels.quant_matmul.qdot_fused`).
* ``"xla"``, the default elsewhere. JAX leaves the convert+dot to XLA,
  which fuses the convert into the operand read. PyTorch has no such
  fusion: convert then matmul would write a bf16 copy of every weight and
  read it back. So on the card a bf16 x goes through K1, which equals
  convert+dot on weights whose subnormal codes are flushed
  (``quantize_params`` flushes them). A float32 x, or a CPU tensor, takes
  JAX's arithmetic in plain torch: the exact convert, a float32-accumulated
  product, the scale after it (MX: dequantize, then dot).
* int4 split-half weights (``_int4_dot``) and group-wise scales take plain
  torch on either device, as JAX takes XLA.

K1 reads row-major ``[K, N]`` codes and the fp8native route column-major
ones: on the card a weight laid out for the other route raises rather than
being copied on every call.

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

A data-parallel world (:func:`rows_split_over`): each rank's activations and
gradients are its rows of a batch cut over a process group. Every
just-in-time scale whose amax runs over the rows (a per-tensor gradient
scale, dW's per-column gradient scales, an MX block along the rows) is then
taken over the whole batch, as JAX's GSPMD program takes it: the rank's
amax is all-reduced (MAX) first; K9's per-column quantize gets the global
amax as one more row of its operand, so its codes and scales are the single
process's bit for bit.

A tensor-parallel world (:func:`k_split_over`): a row-parallel product's
activations hold the rank's slice of K. ``qdot``'s fp8native route then
quantizes each row with its amax over the whole of K, as GSPMD reduces over
a sharded axis: the rank's row amaxes are all-reduced (MAX) over the group
and K9 gets them as one more column, so each rank's codes are the slice of
the single process's codes bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import warnings
from typing import NamedTuple, Optional

import torch

from ..kernels._common import W_KINDS
from ..kernels.quant_matmul import qdot_fused
from .formats import E4M3
from .qtensor import MX_BLOCK, QTensor, _unpack_int4_halves, quantize, quantize_mx
from .recipe import Recipe

__all__ = ["qdot", "qdot_route", "serving_layout", "padded_operands", "fp8_dot", "DotAmaxes",
           "matmul_f32", "rows_split_over", "k_split_over"]


class DotAmaxes(NamedTuple):
    """Amax observations from one quantized dot, fed back into delayed
    state. ``g`` is zero in the forward's output; the backward amax leaves
    through the sink's gradient."""

    x: torch.Tensor
    w: torch.Tensor
    g: torch.Tensor


def _scale_is_post_applicable(w: QTensor) -> bool:
    return w.scale.ndim == 0 or all(d == 1 for d in w.scale.shape[:-1])


def _fp8_weight(w: QTensor) -> bool:
    """An fp8 weight the fp8native route can serve (JAX ``fp8_weight``)."""
    return (w.qvalue.dtype in _FP8_DTYPES and w.block_size is None and w.pack_axis is None
            and _scale_is_post_applicable(w))


def qdot_route(w: QTensor, impl: Optional[str] = None) -> str:
    """The route :func:`qdot` takes for ``w``: ``impl``, else
    ``LLM_FP8_QDOT``, else ``"fp8native"`` for an fp8 weight where native fp8
    products are enabled and ``"xla"`` otherwise (JAX ``qdot :86-91``)."""
    if impl is not None:
        return impl
    default = "fp8native" if (_fp8_weight(w) and _native_fp8_enabled()) else "xla"
    return os.environ.get("LLM_FP8_QDOT", default)


_FP8NATIVE_WARNED = False


def _warn_fp8native_autoselect() -> None:
    """One notice per process when the fp8-operand route was picked by
    default (JAX ``_warn_fp8native_autoselect``)."""
    global _FP8NATIVE_WARNED
    if _FP8NATIVE_WARNED:
        return
    _FP8NATIVE_WARNED = True
    warnings.warn(
        "qdot: auto-selected the fp8-operand route (the card multiplies fp8 "
        "natively). Activations are quantized to e4m3 just-in-time; logits differ "
        "slightly from the dequant route. Pin LLM_FP8_QDOT=xla (or fp8native) to "
        "silence this notice and fix the route.", stacklevel=3)


def _kmajor(q: torch.Tensor) -> bool:
    return q.stride(-2) == 1 and q.shape[-2] > 1


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _fp8native_layout(q: torch.Tensor) -> bool:
    """Whether ``[..., K, N]`` codes are laid out as :func:`serving_layout`
    lays them out for the fp8native route: K-major, rows a multiple of 16
    apart (so the storage holds the zero-padded ``[Np, Kp]`` block)."""
    return _kmajor(q) and q.stride(-1) % 16 == 0


def serving_layout(w: QTensor) -> QTensor:
    """``w`` with its codes laid out for the route :func:`qdot` will take:
    where that route is ``"fp8native"``, the ``.t()`` view of contiguous
    ``[..., Np, Kp]`` codes (``torch._scaled_mm``'s column-major second
    operand), K and N rounded up to multiples of 16 (which cuBLASLt needs:
    BTLM's 6826-wide MLP is not) with zero codes, and the view cut back to
    ``[..., K, N]``; row-major ``[..., K, N]`` otherwise (K1). A stacked
    ``[L, K, N]`` weight is judged by its first layer. One copy, made here."""
    one = w.layer(0) if w.qvalue.ndim == 3 else w
    want_k = qdot_route(one) == "fp8native" and _fp8_weight(one)
    if want_k:
        if _fp8native_layout(w.qvalue):
            return w
        K, N = w.qvalue.shape[-2:]
        store = w.qvalue.new_zeros((*w.qvalue.shape[:-2], _round16(N), _round16(K)))
        store[..., :N, :K] = w.qvalue.transpose(-1, -2)
        return dataclasses.replace(w, qvalue=store[..., :N, :K].transpose(-1, -2))
    if not _kmajor(w.qvalue):
        return w
    return dataclasses.replace(w, qvalue=w.qvalue.contiguous())


def _k1_serves(x: torch.Tensor, w: QTensor) -> bool:
    """K1 computes the xla route's function: bf16 x on the card, unpacked
    fp8/int8 codes, tensor/channel scales or MX blocks along K."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and w.qvalue.ndim == 2
            and w.qvalue.dtype in W_KINDS and w.pack_axis is None):
        return False
    if w.block_size is None:
        return _scale_is_post_applicable(w)
    return w.block_size == MX_BLOCK and w.block_axis == -2 and w.fmt.name != "int4"


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` of one dtype, float32 products and sums
    (JAX ``jnp.dot(..., preferred_element_type=float32)``)."""
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda and a.dtype == torch.bfloat16:
        y = torch.mm(a2, b, out_dtype=torch.float32)
    else:
        y = a2.float() @ b.float()
    return y.reshape(*a.shape[:-1], b.shape[-1])


def _int4_dot(x: torch.Tensor, w: QTensor) -> Optional[torch.Tensor]:
    """``x [..., K] @ w`` for split-half nibble-packed int4 weights as
    ``x_lo @ lo + x_hi @ hi`` (JAX ``_int4_dot``); group scales contract each
    group apart and post-apply its scale. None where a group straddles the
    halves (the caller dequantizes first)."""
    lo, hi = _unpack_int4_halves(w.qvalue)
    kh = w.qvalue.shape[-2]
    x_lo, x_hi = x[..., :kh], x[..., kh:]
    if w.block_size is None and _scale_is_post_applicable(w):
        y = _dot_f32(x_lo, lo.to(x.dtype)) + _dot_f32(x_hi, hi.to(x.dtype))
        return y * w.scale.float().reshape(-1)
    if w.block_size is not None and w.scale.ndim == 2:
        g = w.block_size
        if kh % g:
            return None
        gh, n, s, lead = kh // g, w.qvalue.shape[-1], w.scale.float(), x.shape[:-1]

        def half(xp, wp, sp):
            yg = torch.einsum("...gk,gkn->...gn", xp.float().reshape(*lead, gh, g),
                              wp.float().reshape(gh, g, n))
            return (yg * sp).sum(dim=-2)

        return half(x_lo, lo, s[:gh]) + half(x_hi, hi, s[gh:])
    return None


def qdot(x: torch.Tensor, w: QTensor, *, out_dtype=None, impl: Optional[str] = None
         ) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with ``w`` stored quantized, by the route
    :func:`qdot_route` picks (JAX ``qdot``; the module docstring has the
    routes)."""
    if impl is None and "LLM_FP8_QDOT" not in os.environ and qdot_route(w) == "fp8native":
        _warn_fp8native_autoselect()
    impl = qdot_route(w, impl)
    if impl == "fp8native" and _fp8_weight(w):
        if w.qvalue.is_cuda and not _fp8native_layout(w.qvalue):
            raise ValueError("qdot fp8native: the weight codes are not laid out for this "
                             "route (row-major for K1, or unpadded); quantize_params lays them "
                             "out for the route in force when it runs, so set LLM_FP8_QDOT "
                             "before it")
        xq = _quantize_channel(x, E4M3, x.ndim - 1, margin=0, k=_K_GROUP.group)
        return _narrow_dot(xq, w, out_dtype or x.dtype, "fp8")
    if impl == "fused" and w.pack_axis is None:
        return qdot_fused(x, w, out_dtype=out_dtype or x.dtype)
    out_dtype = out_dtype or x.dtype
    if w.pack_axis is not None and w.pack_axis % w.ndim == w.ndim - 2:
        y = _int4_dot(x, w)
        if y is not None:
            return y.to(out_dtype)
    if _k1_serves(x, w):
        return qdot_fused(x, w, out_dtype=out_dtype)
    if w.block_size is None and _scale_is_post_applicable(w):
        y = _dot_f32(x, w.unpack().to(x.dtype)) * w.scale.float().reshape(-1)
        return y.to(out_dtype)
    return _dot_f32(x, w.dequantize(x.dtype)).to(out_dtype)


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

#: The process group a batch's rows are cut over (:func:`rows_split_over`).
_ROW_GROUP = None


@contextlib.contextmanager
def rows_split_over(group):
    """Within: the ``fp8_dot`` calls made take their row-wise just-in-time
    amaxes over ``group`` (module docstring); their backward keeps the
    group of its forward."""
    global _ROW_GROUP
    prev, _ROW_GROUP = _ROW_GROUP, group
    try:
        yield
    finally:
        _ROW_GROUP = prev


class _KGroup(threading.local):
    group = None


#: The group a row-parallel product's K is cut over (:func:`k_split_over`);
#: per thread, since a ``LocalGroup``'s ranks are threads of one process.
_K_GROUP = _KGroup()


@contextlib.contextmanager
def k_split_over(group):
    """Within (on this thread): ``qdot`` calls on the fp8native route take
    each activation row's amax over ``group``, whose ranks hold the other
    slices of K (a row-parallel product; module docstring). None: no
    change."""
    prev, _K_GROUP.group = _K_GROUP.group, group
    try:
        yield
    finally:
        _K_GROUP.group = prev


#: Columns appended to a row for its global amax: one 16-byte vector of
#: bf16 (two of float32), so K9 keeps its vector loads.
_AMAX_COLS = 16


def _global_amax(t: torch.Tensor, rows, dim=None) -> torch.Tensor:
    """|t|'s amax (over ``dim``, kept, or all of it), all-reduced (MAX)
    over the ``rows`` group."""
    import torch.distributed as dist

    a = t.detach().float().abs()
    a = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    dist.all_reduce(a, op=dist.ReduceOp.MAX, group=rows)
    return a


def _quantize_channel(t: torch.Tensor, fmt, contract_axis: int, margin: int,
                      rows=None, k=None) -> QTensor:
    """Per-channel quantize through K9 (rows of the last axis, or columns of
    a 2-D operand). The TPU's VMEM size guards are not carried over: K9
    takes any length. ``rows``: the group the columns' rows are cut over;
    ``k``: the group the rows' K is cut over."""
    from ..kernels.quantize import quantize_fused  # kernels.quantize imports quant

    if contract_axis == t.ndim - 1:
        t2 = t.reshape(-1, t.shape[-1])
        if k is not None:
            # The group's row amaxes as one more column (zeros after it):
            # K9 finds them as the rows' maxima, the rank's columns get the
            # single process's codes, and the appended columns are dropped.
            from ..parallel.collectives import all_reduce_max

            top = all_reduce_max(t2.detach().float().abs().amax(dim=1, keepdim=True), k)
            pad = t2.new_zeros((t2.shape[0], _AMAX_COLS))
            pad[:, :1] = top.to(t2.dtype)
            q = quantize_fused(torch.cat([t2, pad], dim=1), fmt, axis=-1, margin=margin)
            codes = q.qvalue[:, :t2.shape[1]].contiguous()
        else:
            q = quantize_fused(t2, fmt, axis=-1, margin=margin)
            codes = q.qvalue
        return QTensor(qvalue=codes.reshape(t.shape),
                       scale=q.scale.reshape(*t.shape[:-1], 1), fmt=fmt)
    if t.ndim == 2 and contract_axis == 0:
        if rows is None:
            return quantize_fused(t, fmt, axis=0, margin=margin)
        # The world's column amaxes as one more row: K9 finds them as the
        # columns' maxima, and the rank's rows get the single process's codes.
        top = _global_amax(t, rows, dim=0).to(t.dtype)
        q = quantize_fused(torch.cat([t, top]), fmt, axis=0, margin=margin)
        return QTensor(qvalue=q.qvalue[:-1], scale=q.scale, fmt=fmt)
    if rows is not None:
        raise NotImplementedError("a per-channel quantize over the rows of a >2-D operand "
                                  "in a data-parallel world")
    return quantize(t, fmt, axes=(contract_axis,), margin=margin)


def _tensor_scaled(t: torch.Tensor, fmt, margin: int, rows=None) -> QTensor:
    """Per-tensor just-in-time quantize, its amax over the ``rows`` group."""
    if rows is None:
        return quantize(t, fmt, axes=None, margin=margin)
    from .qtensor import compute_scale

    return quantize(t, fmt, axes=None, margin=margin,
                    scale=compute_scale(_global_amax(t, rows), fmt, margin))


def _mx_rows(t: torch.Tensor, block_axis: int, rows) -> None:
    """MX blocks along the rows of a batch cut over ``rows`` are the single
    process's only if each rank's rows fill whole blocks."""
    if rows is not None and t.shape[block_axis] % MX_BLOCK:
        raise NotImplementedError(f"MX blocks along {t.shape[block_axis]} rows a rank: a "
                                  f"data-parallel world needs a multiple of {MX_BLOCK}")


def _q_fwd(t: torch.Tensor, recipe: Recipe, scale, contract_axis: int) -> QTensor:
    """Quantize a forward operand according to the recipe granularity."""
    if recipe.granularity == "block32":
        return quantize_mx(t, recipe.fmt_fwd, block_axis=contract_axis, block_size=MX_BLOCK)
    if recipe.granularity == "channel":
        return _quantize_channel(t, recipe.fmt_fwd, contract_axis, recipe.margin)
    return quantize(t, recipe.fmt_fwd, axes=None, scale=scale, margin=recipe.margin)


def _q_bwd(g: torch.Tensor, recipe: Recipe, contract_axis: int, rows=None) -> QTensor:
    """Quantize a gradient: just-in-time scale in the backward format
    (``rows``: the group its rows are cut over, when ``contract_axis`` runs
    over them or the scale is per tensor)."""
    along_rows = rows if contract_axis == 0 else None
    if recipe.granularity == "block32":
        _mx_rows(g, contract_axis, along_rows)
        if g.shape[contract_axis] % MX_BLOCK == 0:
            return quantize_mx(g, recipe.fmt_bwd, block_axis=contract_axis,
                               block_size=MX_BLOCK)
    if recipe.granularity == "channel":
        return _quantize_channel(g, recipe.fmt_bwd, contract_axis, recipe.margin, along_rows)
    return _tensor_scaled(g, recipe.fmt_bwd, recipe.margin, rows)


def _mx_or_tensor(t: torch.Tensor, fmt, block_axis: int, rows=None) -> QTensor:
    _mx_rows(t, block_axis, rows)
    if t.shape[block_axis] % MX_BLOCK == 0:
        return quantize_mx(t, fmt, block_axis=block_axis, block_size=MX_BLOCK)
    return _tensor_scaled(t, fmt, 0, rows)


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


@functools.lru_cache(maxsize=None)
def _unit_scale(device: torch.device) -> torch.Tensor:
    """The 0-d float32 one ``torch._scaled_mm`` takes as both scales (made
    once per device: the serving route calls it per projection)."""
    return torch.ones((), dtype=torch.float32, device=device)


def padded_operands(a: torch.Tensor, b: torch.Tensor):
    """``a [M, K]`` and ``b [K, N]`` codes as ``[M, Kp]`` and ``[Kp, Np]``
    (K and N rounded up to multiples of 16) with zero codes in the padding,
    so that ``(a_p @ b_p)[:, :N]`` is ``a @ b`` exactly (zero codes add
    nothing; the scales post-apply). ``a`` is padded here (a copy of the
    activation codes); ``b`` must be the K-major view :func:`serving_layout`
    made, whose storage already holds the padded block: it is read in place,
    never padded per call."""
    K, N = b.shape
    Kp, Np = _round16(K), _round16(N)
    ld = b.stride(1)
    if not _fp8native_layout(b) or ld < Kp or (b.storage_offset() + (Np - 1) * ld + Kp) \
            * b.element_size() > b.untyped_storage().nbytes():
        raise ValueError(f"fp8 matmul: a [{K}, {N}] weight needs its codes padded to "
                         f"multiples of 16 once, by serving_layout (quantize_params and "
                         "quantize_zoo_params call it)")
    a_p = a.new_zeros((a.shape[0], Kp))
    a_p[:, :K] = a
    return a_p, b.as_strided((Kp, Np), (1, ld))


def _codes_mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of one-byte codes, accumulated in float32
    (``"fp8"``) or int32 (``"int"``), returned as float32. ``b`` may be any
    view (a transpose included); the card's products get the layouts
    cuBLASLt takes. ``torch._scaled_mm`` takes any M (checked on the H100
    with torch 2.11 at M = 1, 5, 8, 17, 128 and 8184), so decode slots and
    ragged prefill rows are not padded. It needs K and N to be multiples of
    16: a weight where they are not (BTLM's 6826-wide MLP, debug-btlm's 340)
    is multiplied through :func:`padded_operands`, its codes padded once by
    :func:`serving_layout`."""
    if not a.is_cuda:
        return a.float() @ b.float()
    if mode == "int":
        return torch._int_mm(a.contiguous(), b.contiguous()).float()
    if a.stride(-1) != 1:
        a = a.contiguous()
    N = b.shape[1]
    if a.shape[1] % 16 or N % 16:
        a, b = padded_operands(a, b)
    elif b.stride(0) != 1:  # column-major second operand
        b = b.t().contiguous().t()
    one = _unit_scale(a.device)
    try:
        return torch._scaled_mm(a, b, one, one, out_dtype=torch.float32)[:, :N]
    except RuntimeError as e:
        raise RuntimeError(f"fp8 matmul of {a.dtype} x {b.dtype} with a float32 output "
                           f"was refused: {e}") from e


def _narrow_dot(aq: QTensor, bq: QTensor, out_dtype, mode: str) -> torch.Tensor:
    """``a [..., K] @ b [K, N]`` with narrow operands, scales after: both
    scales are constant along the contraction, so they post-apply exactly."""
    a = aq.qvalue.reshape(-1, aq.qvalue.shape[-1])
    acc = _codes_mm(a, bq.qvalue, mode).reshape(*aq.qvalue.shape[:-1], bq.qvalue.shape[-1])
    # In place on the fresh float32 product: (acc · sa) · sb, as JAX rounds it.
    return acc.mul_(aq.scale.float()).mul_(bq.scale.float().reshape(-1)).to(out_dtype)


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
        ctx.recipe, ctx.mode, ctx.rows = recipe, mode, _ROW_GROUP
        ctx.x_res, ctx.wq = x_res, wq
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        ctx.mark_non_differentiable(x_amax, w_amax, zero)
        return y, x_amax, w_amax, zero

    @staticmethod
    def backward(ctx, gy, *_amax_grads):
        recipe, mode, x_res, wq, rows = ctx.recipe, ctx.mode, ctx.x_res, ctx.wq, ctx.rows
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
            gq_dw = _quantize_channel(g_dw, recipe.fmt_bwd, 0, recipe.margin, rows)
            acc = _codes_mm(x8.t(), gq_dw.qvalue, mode)
            dw = (acc * gq_dw.scale.float().reshape(-1)).to(ctx.w_dtype)
            return dx, dw, None, None, g_amax, None

        xv = (x_res.dequantize(torch.bfloat16) if isinstance(x_res, QTensor)
              else x_res.to(torch.bfloat16))
        wv = wq.dequantize(torch.bfloat16)
        # dx = g @ wᵀ: the gradient quantizes along its last axis; the block
        # recipe requantizes w transposed (TE keeps both orientations).
        gq_for_dx = _q_bwd(gy, recipe, contract_axis=gy.ndim - 1, rows=rows)
        if recipe.granularity == "block32":
            wT = _mx_or_tensor(wv.t().float(), recipe.fmt_bwd, block_axis=1).dequantize(
                torch.bfloat16)
        else:
            wT = wv.t()
        dx = _bf16_dot(gq_for_dx.dequantize(torch.bfloat16), wT, ctx.x_dtype)
        # dw = xᵀ @ g: contraction over the batch rows.
        x2 = xv.reshape(-1, xv.shape[-1])
        g2 = gy.reshape(-1, gy.shape[-1]).float()
        gq_for_dw = _q_bwd(g2, recipe, contract_axis=0, rows=rows)
        if recipe.granularity == "block32":
            xT = _mx_or_tensor(x2.t().float(), recipe.fmt_bwd, block_axis=1,
                               rows=rows).dequantize(torch.bfloat16)
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
