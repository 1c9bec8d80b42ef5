"""K3: flash-attention forward (out and log-sum-exp) over bshd tensors.

Counterpart of ``llm_fp8_tpu/kernels/flash_attention.py::flash_attention``
(forward: ``_flash_fwd_call``). On a CUDA tensor the wrapper launches
``csrc/flash_attention.cu``; on a CPU tensor it takes :func:`flash_fwd_plain`.

Supported: causal with a per-batch ``q_offset``, ``kv_lens``, GQA through the
head map, sliding window, softcap and the logit scale. ALiBi,
``attention_chunk``, segment ids and dropout are not ported yet and raise on
both devices. The autograd function's backward is K6
(:mod:`.flash_attention_bwd`): its kernels on CUDA tensors, its plain version
on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .flash_attention_bwd import flash_attention_bwd

__all__ = ["flash_attention", "flash_fwd_plain", "MASK_VALUE"]

#: -0.7 * f32 max, as the TPU kernel: finite so the online update never NaNs.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def flash_fwd_plain(q, k, v, q_offset, kv_lens, *, causal, window, softcap, scale):
    """The kernel's function in plain PyTorch: float32 scores, bf16 P for the
    PV product, dead rows → out 0 and lse -inf. Returns ``(out, lse [B, Hq, Sq])``."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    k_pos = torch.arange(Sk, device=q.device)
    mask = k_pos[None, None, :] < kv_lens.long()[:, None, None]
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    s = torch.where(mask[:, None], s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = p.to(v.dtype).float() @ vf
    dead = (l == 0.0) | (m <= MASK_VALUE * 0.5)
    l_inv = torch.where(dead, torch.zeros_like(l), 1.0 / torch.where(l == 0.0, torch.ones_like(l), l))
    out = (pv * l_inv).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = torch.where(dead, torch.full_like(l, -float("inf")), m + torch.log(l))
    return out, lse[..., 0]


def _launch(q, k, v, q_offset, kv_lens, causal, window, softcap, scale):
    lib = _build.library("flash_attention")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_launch(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(lse.data_ptr()), ctypes.c_void_p(q_offset.data_ptr()),
        ctypes.c_void_p(kv_lens.data_ptr()), ctypes.c_int(B), ctypes.c_int(Sq),
        ctypes.c_int(Sk), ctypes.c_int(Hq), ctypes.c_int(Hk), ctypes.c_int(D),
        ctypes.c_float(scale), ctypes.c_int(int(causal)),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


class _FlashForward(torch.autograd.Function):
    """Forward through K3, backward through K6 from the saved out and LSE
    (the LSE itself gets no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_lens, cfg):
        if q.is_cuda:
            out, lse = _launch(q, k, v, q_offset, kv_lens, **cfg)
        else:
            out, lse = flash_fwd_plain(q, k, v, q_offset, kv_lens, **cfg)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse, q_offset, kv_lens)
        ctx.cfg = cfg
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_offset, kv_lens = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         q_offset=q_offset, kv_lens=kv_lens, **ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D] bf16
    k: torch.Tensor,  # [B, Sk, Hk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    alibi_slopes=None,
    attention_chunk: Optional[int] = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    dropout_p: float = 0.0,
    return_lse: bool = False,
):
    """Flash attention forward; semantics of :func:`..ops.attention.attention_ref`.

    Returns ``out [B, Sq, Hq, D]``, or ``(out, lse [B, Hq, Sq] float32)``
    with ``return_lse``. Counts kernel launches in ``flash_attention.launches``.
    """
    if alibi_slopes is not None:
        raise NotImplementedError("flash attention: ALiBi is not ported yet")
    if attention_chunk is not None:
        raise NotImplementedError("flash attention: attention_chunk is not ported yet")
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError("flash attention: segment ids are not ported yet")
    if dropout_p != 0.0:
        raise NotImplementedError("flash attention: dropout is not ported yet")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hq % Hk or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash attention takes bf16 q, k and v")
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} not in (32, 64, 128)")
    dev = q.device
    if not (k.device == v.device == dev):
        raise ValueError("q, k and v must be on one device")
    q_offset = torch.as_tensor(q_offset, dtype=torch.int32, device=dev).expand(B).contiguous()
    kv_lens = (torch.full((B,), Sk, dtype=torch.int32, device=dev) if kv_lens is None
               else kv_lens.to(device=dev, dtype=torch.int32).contiguous())
    cfg = dict(causal=causal, window=window, softcap=softcap,
               scale=scale if scale is not None else D ** -0.5)
    out, lse = _FlashForward.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                   q_offset, kv_lens, cfg)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
