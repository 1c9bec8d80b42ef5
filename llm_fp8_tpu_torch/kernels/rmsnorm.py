"""K8: fused residual add + RMSNorm, ``(norm(x + residual) * weight, x + residual)``.

Counterpart of ``llm_fp8_tpu/kernels/rmsnorm.py::rmsnorm_residual_fused``.
On a CUDA tensor the wrapper launches ``csrc/rmsnorm.cu``; on a CPU tensor it
takes :func:`rmsnorm_residual_plain`. Both compute the norm from the float32
sum ``x + residual`` before it is rounded to x's dtype, as the TPU kernel
does; :func:`..ops.rmsnorm.rmsnorm_residual` rounds the sum first, so for
bf16 the two differ by a rounding.

The gradient is the TPU kernel's custom VJP in plain PyTorch on both devices
(the JAX package has no backward kernel here): the statistics are recomputed
from the saved sum, and the sum's gradient goes to both x and residual.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rmsnorm_residual_fused", "rmsnorm_residual_plain"]

#: Activation dtype → kind code of ``csrc/rmsnorm.cu``.
_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_residual_plain(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                           eps: float = 1e-5):
    """The kernel's function in plain PyTorch: ``(y, s)`` in x's dtype, y
    from the unrounded float32 sum."""
    s32 = x.float() + residual.float()
    var = (s32 * s32).mean(dim=-1, keepdim=True)
    y = s32 * torch.rsqrt(var + eps) * weight.float()
    return y.to(x.dtype), s32.to(x.dtype)


def _launch(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, eps: float):
    lib = _build.library("rmsnorm")
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    r2 = residual.reshape(-1, D).contiguous()
    w32 = weight.float().contiguous()
    y, s = torch.empty_like(x2), torch.empty_like(x2)
    err = lib.rmsnorm_residual_launch(
        ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(r2.data_ptr()),
        ctypes.c_void_p(w32.data_ptr()), ctypes.c_void_p(y.data_ptr()),
        ctypes.c_void_p(s.data_ptr()), ctypes.c_int(x2.shape[0]), ctypes.c_int(D),
        ctypes.c_int(_KINDS[x.dtype]), ctypes.c_float(eps),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "rmsnorm_residual_fused")
    rmsnorm_residual_fused.launches += 1
    return y.reshape(x.shape), s.reshape(x.shape)


class _RMSNormResidual(torch.autograd.Function):
    """Forward through K8 (or its plain version on the CPU); backward as the
    TPU kernel's ``_bwd_rule``."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        if x.is_cuda:
            y, s = _launch(x, residual, weight, eps)
        else:
            y, s = rmsnorm_residual_plain(x, residual, weight, eps)
        ctx.save_for_backward(s, weight)
        ctx.eps = eps
        return y, s

    @staticmethod
    def backward(ctx, dy, ds_out):
        s, weight = ctx.saved_tensors
        s32, w32, dy32 = s.float(), weight.float(), dy.float()
        rstd = torch.rsqrt((s32 * s32).mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = s32 * rstd
        wdy = dy32 * w32
        dw = (dy32 * xhat).sum(dim=tuple(range(s.ndim - 1))).to(weight.dtype)
        d_s = (wdy - xhat * (wdy * xhat).mean(dim=-1, keepdim=True)) * rstd
        d_s = (d_s + ds_out.float()).to(s.dtype)
        return d_s, d_s, dw, None


def rmsnorm_residual_fused(x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor,
                           eps: float = 1e-5, block_rows: int = 256):
    """Fused ``(rmsnorm(x + residual) * weight, x + residual)`` over the last
    axis, both in x's dtype (float32 or bf16); any leading shape and row
    count. ``block_rows`` is the TPU kernel's tile and is accepted for API
    parity: it does not change the result. Differentiable. Counts kernel
    launches in ``rmsnorm_residual_fused.launches``."""
    del block_rows
    if x.dtype not in _KINDS or residual.dtype != x.dtype:
        raise TypeError("rmsnorm_residual_fused takes float32 or bf16 x and a residual of "
                        f"its dtype, got {x.dtype} and {residual.dtype}")
    if residual.shape != x.shape or weight.shape != (x.shape[-1],):
        raise ValueError(f"shapes x {tuple(x.shape)}, residual {tuple(residual.shape)}, "
                         f"weight {tuple(weight.shape)}")
    if not (residual.device == weight.device == x.device):
        raise ValueError("x, residual and weight must be on one device")
    return _RMSNormResidual.apply(x, residual, weight, float(eps))


rmsnorm_residual_fused.launches = 0
