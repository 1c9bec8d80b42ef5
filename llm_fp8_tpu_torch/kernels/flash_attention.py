"""K3: flash-attention forward (out and log-sum-exp) over bshd tensors, and
K7: its FP8-compute variant.

Counterpart of ``llm_fp8_tpu/kernels/flash_attention.py::flash_attention``
(forward: ``_flash_fwd_call``). On a CUDA tensor the wrapper launches
``csrc/flash_attention.cu``; on a CPU tensor it takes :func:`flash_fwd_plain`.
The kernel is built for Hopper: TMA loads K/V tiles into a ring of swizzled
shared memory for consumer warpgroups that run Q·Kᵀ and P·V on ``wgmma``
with the scores, P and O kept in registers (its source note has the design;
head dims 32, 64, 128, and 256 on 64-key tiles for Gemma-2; the MLA
family's 192 and 24 and debug-vit's 16 zero-padded to 256 and 32 by the
wrapper, :data:`PADDED_HEAD_DIMS`).
float32 q, k and v (the GPT-2 and NeoX families serve in float32) take K3's
float32 instance, :func:`flash_fwd_f32` (``csrc/flash_attention_f32.cu``:
``wgmma`` TF32 products with a 3xTF32 split, so float32 accuracy; head
dims 32, 64, 80, 128 and 256; causal, ``q_offset``, ``kv_lens``, GQA, the
scale, ALiBi and dropout; no window, softcap, chunk or segment ids: the
wrapper raises on them for CUDA tensors). Its autograd backward is
K6's float32 instance (``flash_attention_bwd.flash_attention_bwd_f32``).
:func:`flash_attention_fp8` (K7, ``csrc/flash_attention_fp8.cu``, plain
version :func:`flash_fp8_plain`) is the counterpart of the JAX
``flash_attention_fp8``: e4m3 q/k/v with FA3 descales, forward only. Its
native route from 64 query rows up runs on ``wgmma`` with a TMA ring
(:func:`fp8_wgmma_ok`), after a pre-pass that widens Q and K to bf16 and
lays V out key-contiguous (:func:`fp8_prepass`); shorter queries and the
dequant route take its ``mma.sync`` kernel.

Supported: causal with a per-batch ``q_offset``, ``kv_lens``, GQA through the
head map, sliding window, softcap, the logit scale, ALiBi (``-slope·|q_pos -
k_pos|`` after softcap, ``[Hq]`` or ``[B, Hq]`` slopes) and attention dropout
(``dropout_p``, ``dropout_seed``: the counter hash of
``_common.dropout_keep_mask``, ``csrc/dropout.cuh`` on the card, applied to P
before P·V with the LSE taken from the undropped P), ``attention_chunk``
(a query sees only keys of its own length-C chunk, ``floor(q_pos/C)·C <=
k_pos < + C``) and segment ids (``q_segment_ids [B, Sq]``, ``kv_segment_ids
[B, Sk]``: a query sees only keys of its own id, the packed sequences of
``ops/varlen.py``). A negative ``q_offset`` (split-KV's later chunks) is
taken: rows with no live key give out 0 and LSE -inf. The autograd
function's backward is K6 (:mod:`.flash_attention_bwd`): its kernels on CUDA
tensors, its plain version on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..utils.backend import native_fp8_matmul
from . import _build
from ._common import (PADDED_HEAD_DIMS, aligned16, alibi_bias, alibi_slopes_tensor,
                      dropout_args, dropout_inv, dropout_keep, f32_card_refuses, live_mask,
                      pad_head_dim, segment_ids_tensor)
from .flash_attention_bwd import flash_attention_bwd

__all__ = ["flash_attention", "flash_fwd_plain", "flash_fwd_f32", "F32_HEAD_DIMS",
           "f32_card_refuses",
           "BF16_HEAD_DIMS", "PADDED_HEAD_DIMS", "pad_head_dim",
           "flash_attention_fp8", "flash_fp8_plain",
           "fp8_prepass", "fp8_prepass_plain", "fp8_v_slots_plain", "fp8_wgmma_ok",
           "auto_block", "MASK_VALUE"]

#: -0.7 * f32 max, as the TPU kernel: finite so the online update never NaNs.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def flash_fwd_plain(q, k, v, q_offset, kv_lens, *, causal, window, softcap, scale,
                    alibi=None, dropout_p: float = 0.0, dropout_seed=0,
                    attention_chunk=None, q_segment_ids=None, kv_segment_ids=None):
    """The kernel's function in plain PyTorch: float32 scores, P rounded to
    V's dtype for the PV product (bf16 for the bf16 kernel; float32 P for
    float32 V, as the TPU kernel's ``p.astype(v.dtype)``), dead rows → out 0
    and lse -inf. ``alibi``: float32 ``[B,
    Hq]`` slopes or None. With dropout the kept entries of P, times
    ``1/(1 - p)``, feed P·V and the LSE is the undropped P's. The mask is
    :func:`._common.live_mask` (``kv_lens``, causal, window, chunk, segment
    ids). Returns ``(out, lse [B, Hq, Sq])``."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if alibi is not None:
        s = s + alibi_bias(alibi, q_offset, Sq, Sk)
    mask = live_mask(q_offset, kv_lens, Sq, Sk, causal=causal, window=window,
                     attention_chunk=attention_chunk, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids)
    s = torch.where(mask[:, None], s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:
        keep = dropout_keep(dropout_seed, dropout_p, q_offset, B, Hq, Sq, Sk)
        p = torch.where(keep, p, torch.zeros_like(p)) * dropout_inv(dropout_p)
    pv = p.to(v.dtype).float() @ vf
    dead = (l == 0.0) | (m <= MASK_VALUE * 0.5)
    l_inv = torch.where(dead, torch.zeros_like(l), 1.0 / torch.where(l == 0.0, torch.ones_like(l), l))
    out = (pv * l_inv).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = torch.where(dead, torch.full_like(l, -float("inf")), m + torch.log(l))
    return out, lse[..., 0]


def _launch(q, k, v, q_offset, kv_lens, causal, window, softcap, scale, alibi=None,
            dropout_p=0.0, dropout_seed=0, attention_chunk=None, q_segment_ids=None,
            kv_segment_ids=None):
    lib = _build.library("flash_attention")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_launch(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(lse.data_ptr()), ctypes.c_void_p(q_offset.data_ptr()),
        ctypes.c_void_p(kv_lens.data_ptr()),
        ctypes.c_void_p(alibi.data_ptr() if alibi is not None else 0),
        ctypes.c_void_p(q_segment_ids.data_ptr() if q_segment_ids is not None else 0),
        ctypes.c_void_p(kv_segment_ids.data_ptr() if kv_segment_ids is not None else 0),
        ctypes.c_int(B), ctypes.c_int(Sq), ctypes.c_int(Sk), ctypes.c_int(Hq), ctypes.c_int(Hk),
        ctypes.c_int(D), ctypes.c_float(scale), ctypes.c_int(int(causal)),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_int(attention_chunk or 0), *dropout_args(dropout_p, dropout_seed),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


#: Head dims of the float32 instance (GPT-2/OPT/Falcon 64, SantaCoder and
#: Pythia-1.4B 128, BTLM 80, GPT-J 256, the debug configs 32).
F32_HEAD_DIMS = (32, 64, 80, 128, 256)

#: Head dims of the bf16 kernel (the Llama family's 64 and 128, Gemma-2's
#: 256 on 64-key tiles, the debug configs 32).
BF16_HEAD_DIMS = (32, 64, 128, 256)


def flash_fwd_f32(q, k, v, q_offset, kv_lens, *, causal: bool, scale: float, alibi=None,
                  dropout_p: float = 0.0, dropout_seed=0, passes: int = 3):
    """K3's float32 instance on CUDA tensors: float32 ``q [B, Sq, Hq, D]``,
    ``k``/``v [B, Sk, Hk, D]``, int32 ``[B]`` ``q_offset`` and ``kv_lens``,
    float32 ``[B, Hq]`` ALiBi slopes or None, attention dropout
    (``dropout_p``, ``dropout_seed``). Returns ``(out, lse [B, Hq, Sq])``,
    :func:`flash_fwd_plain`'s function. ``passes=1`` runs the products in
    single-pass TF32 (2^-11 off: the planted fault the card's checks must
    catch). Counts launches in ``flash_fwd_f32.launches``."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"flash_fwd_f32 takes float32 q, k and v, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in F32_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {F32_HEAD_DIMS}")
    if passes not in (1, 3):
        raise ValueError(f"passes {passes} is not 1 or 3")
    lib = _build.library("flash_attention_f32")
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    p = ctypes.c_void_p
    err = lib.flash_fwd_f32_launch(
        p(q.data_ptr()), p(k.data_ptr()), p(v.data_ptr()), p(out.data_ptr()),
        p(lse.data_ptr()), p(q_offset.data_ptr()), p(kv_lens.data_ptr()),
        p(alibi.data_ptr() if alibi is not None else 0), B, Sq, Sk, Hq, Hk, D,
        ctypes.c_float(scale), int(causal), passes, *dropout_args(dropout_p, dropout_seed),
        p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(lib, err, "flash_attention_f32")
    flash_fwd_f32.launches += 1
    return out, lse


flash_fwd_f32.launches = 0


def _per_row(q_offset, kv_lens, B: int, Sk: int, dev):
    """``q_offset`` (a scalar or ``[B]``) and ``kv_lens`` (``[B]``, default
    Sk) as contiguous int32 ``[B]`` tensors on ``dev``: the kernels read one
    of each per batch row."""
    q_offset = torch.as_tensor(q_offset, dtype=torch.int32, device=dev).expand(B).contiguous()
    if kv_lens is None:
        return q_offset, torch.full((B,), Sk, dtype=torch.int32, device=dev)
    if tuple(kv_lens.shape) != (B,):
        raise ValueError(f"kv_lens of shape {tuple(kv_lens.shape)}, want [{B}]")
    return q_offset, kv_lens.to(device=dev, dtype=torch.int32).contiguous()


class _FlashForward(torch.autograd.Function):
    """Forward through K3, backward through K6 from the saved out and LSE
    (the LSE itself gets no gradient; the segment ids ride along, as JAX's
    ``_flash_bwd_rule`` passes them and the chunk to its backward)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_lens, alibi, q_seg, kv_seg, cfg):
        seg = dict(q_segment_ids=q_seg, kv_segment_ids=kv_seg)
        if q.is_cuda and q.dtype == torch.float32:
            out, lse = flash_fwd_f32(q, k, v, q_offset, kv_lens, causal=cfg["causal"],
                                     scale=cfg["scale"], alibi=alibi,
                                     dropout_p=cfg["dropout_p"],
                                     dropout_seed=cfg["dropout_seed"])
        elif q.is_cuda:
            out, lse = _launch(q, k, v, q_offset, kv_lens, alibi=alibi, **seg, **cfg)
        else:
            out, lse = flash_fwd_plain(q, k, v, q_offset, kv_lens, alibi=alibi, **seg, **cfg)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse, q_offset, kv_lens, alibi, q_seg, kv_seg)
        ctx.cfg = cfg
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_offset, kv_lens, alibi, q_seg, kv_seg = ctx.saved_tensors
        # float32 CUDA tensors take K6's float32 instance (flash_attention_bwd
        # sends them there).
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         q_offset=q_offset, kv_lens=kv_lens, alibi=alibi,
                                         q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                         **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D] bf16 or float32
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
    dropout_seed=0,
    return_lse: bool = False,
):
    """Flash attention forward; semantics of :func:`..ops.attention.attention_ref`.

    Returns ``out [B, Sq, Hq, D]``, or ``(out, lse [B, Hq, Sq] float32)``
    with ``return_lse``. A head dim of :data:`PADDED_HEAD_DIMS` (16, 24, 192)
    runs zero-padded to its instance's (32, 32, 256) on either device, the
    autograd of the pad and the slice carrying the gradients. Counts the
    bf16 kernel's launches in ``flash_attention.launches`` (the float32
    instance's in ``flash_fwd_f32.launches``).
    ``alibi_slopes`` (``[Hq]`` or ``[B, Hq]``) gets no gradient; segment ids
    (``[B, Sq]`` and ``[B, Sk]`` integers, both or neither) and
    ``attention_chunk`` (a positive int) mask as :func:`._common.live_mask`.
    """
    if attention_chunk is not None and attention_chunk <= 0:
        raise ValueError(f"attention_chunk {attention_chunk} is not positive")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p {dropout_p} outside [0, 1)")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hq % Hk or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes bf16 or float32 q, k and v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    f32 = q.dtype == torch.float32
    dims = F32_HEAD_DIMS if f32 else BF16_HEAD_DIMS
    if D in PADDED_HEAD_DIMS:
        Dp = PADDED_HEAD_DIMS[D]
        out = flash_attention(
            pad_head_dim(q, Dp), pad_head_dim(k, Dp), pad_head_dim(v, Dp), causal=causal,
            window=window, softcap=softcap, scale=scale if scale is not None else D ** -0.5,
            q_offset=q_offset, kv_lens=kv_lens, alibi_slopes=alibi_slopes,
            attention_chunk=attention_chunk, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, dropout_p=dropout_p, dropout_seed=dropout_seed,
            return_lse=return_lse)
        return (out[0][..., :D], out[1]) if return_lse else out[..., :D]
    if D not in dims:
        raise ValueError(f"head_dim {D} not in {dims} (or {tuple(PADDED_HEAD_DIMS)}, padded)")
    if f32 and q.is_cuda:
        f32_card_refuses(window, softcap, attention_chunk, q_segment_ids)
    dev = q.device
    if not (k.device == v.device == dev):
        raise ValueError("q, k and v must be on one device")
    q_offset, kv_lens = _per_row(q_offset, kv_lens, B, Sk, dev)
    alibi = alibi_slopes_tensor(alibi_slopes, Hq, dev, batch=B)
    q_seg, kv_seg = segment_ids_tensor(q_segment_ids, kv_segment_ids, B, Sq, Sk, dev)
    cfg = dict(causal=causal, window=window, softcap=softcap,
               scale=scale if scale is not None else D ** -0.5,
               dropout_p=float(dropout_p), dropout_seed=int(dropout_seed),
               attention_chunk=attention_chunk)
    out, lse = _FlashForward.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                   q_offset, kv_lens, alibi, q_seg, kv_seg, cfg)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def auto_block(seq: int) -> int:
    """The TPU kernel's default tile (``_auto_block``): the largest of 512 and
    256 that the sequence fills (its padded length within 25% of the 128-tile
    padded length), else 128. For K7 the key tile is part of the function.
    (The JAX helper's ``LLM_FP8_FLASH_BLOCK`` override is not ported.)"""
    def pad_to(b):
        return -(-seq // b) * b

    base = pad_to(128)
    for b in (512, 256):
        if seq >= b and pad_to(b) <= 1.25 * base:
            return b
    return 128


def flash_fp8_plain(q, k, v, descale, q_offset, kv_lens, *, causal, window, softcap, scale,
                    block_k, out_dtype=torch.bfloat16):
    """K7's function in plain PyTorch, walking the ``block_k``-key tiles as the
    TPU kernel does: per tile the running max ``m'``, ``p = exp(s - m')``
    summed unquantized into ``l``, ``p`` rounded to e4m3 for the float32
    ``p8 @ v``. ``descale`` is ``[3, B, Hk]`` (q, k, v). Returns ``out [B, Sq,
    Hq, D]`` in ``out_dtype``."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    qkd = (descale[0] * descale[1]).repeat_interleave(g, dim=1)[:, :, None, None]
    vd = descale[2].repeat_interleave(g, dim=1)[:, :, None, None]
    q_pos = (q_offset.long()[:, None] + torch.arange(Sq, device=dev)[None, :])[:, None, :, None]
    lens = kv_lens.long()[:, None, None, None]
    m = torch.full((B, Hq, Sq, 1), -float("inf"), device=dev)
    l = torch.zeros((B, Hq, Sq, 1), device=dev)
    acc = torch.zeros((B, Hq, Sq, D), device=dev)
    for k0 in range(0, Sk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (qf @ kt.transpose(-1, -2)) * scale
        s = s * qkd
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = torch.arange(k0, k0 + kt.shape[2], device=dev)[None, None, None, :]
        mask = k_pos < lens
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, torch.full_like(s, MASK_VALUE))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(torch.float8_e4m3fn).float() @ vt
        m = m_next
    dead = (l == 0.0) | (m <= MASK_VALUE * 0.5)
    l_inv = torch.where(dead, torch.zeros_like(l),
                        1.0 / torch.where(l == 0.0, torch.ones_like(l), l))
    out = acc * l_inv * vd
    return out.to(out_dtype).permute(0, 2, 1, 3).contiguous()


def _slot_keys() -> torch.Tensor:
    """The key held by each slot of a 32-key group of :func:`fp8_v_slots_plain`:
    slot ``16h + 4t + u`` holds key ``16h + 2t + (u & 1) + 8 (u >> 1)``, the
    keys lane ``t`` of a quad holds in the scores' accumulator, so that P's
    e4m3 codes form P·V's A fragment where they stand
    (``csrc/flash_attention_fp8.cu::slot_key``)."""
    j = torch.arange(32)
    u, t, h = j & 3, (j >> 2) & 3, (j >> 4) & 1
    return 16 * h + 2 * t + (u & 1) + 8 * (u >> 1)


def fp8_v_slots_plain(v: torch.Tensor) -> torch.Tensor:
    """The wgmma route's V pre-pass in plain PyTorch: ``v [B, Sk, Hk, D]`` →
    ``[B, Hk, D, Skp]`` (``Skp`` = Sk rounded up to 32), each 32-key group in
    slot order (:func:`_slot_keys`), zeros past Sk."""
    B, Sk, Hk, D = v.shape
    Skp = -(-Sk // 32) * 32
    codes = v.view(torch.uint8)
    if Skp > Sk:
        codes = torch.cat([codes, codes.new_zeros((B, Skp - Sk, Hk, D))], dim=1)
    keys = (torch.arange(Skp) // 32 * 32 + _slot_keys().repeat(Skp // 32)).to(v.device)
    return codes[:, keys].permute(0, 2, 3, 1).contiguous().view(v.dtype)


def fp8_prepass_plain(q, k, v):
    """The wgmma route's pre-pass in plain PyTorch: q and k widened to bf16
    (exactly: every e4m3 value is a bf16 value) and v in slot order
    (:func:`fp8_v_slots_plain`)."""
    return q.to(torch.bfloat16), k.to(torch.bfloat16), fp8_v_slots_plain(v)


def fp8_prepass(q, k, v):
    """:func:`fp8_prepass_plain`: its CUDA kernels on CUDA tensors (K7's
    wgmma route runs it inside its call), the plain version on CPU tensors."""
    if not q.is_cuda:
        return fp8_prepass_plain(q, k, v)
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    Skp = -(-Sk // 32) * 32
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    qb = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    kb = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
    vt = torch.empty((B, Hk, D, Skp), dtype=v.dtype, device=q.device)
    lib = _build.library("flash_attention_fp8")
    p = ctypes.c_void_p
    err = lib.flash_fp8_prep_launch(p(q.data_ptr()), p(k.data_ptr()), p(v.data_ptr()),
                                    p(qb.data_ptr()), p(kb.data_ptr()), p(vt.data_ptr()), B, Sq,
                                    Sk, Hq, Hk, D, Skp,
                                    p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(lib, err, "flash_attention_fp8 (pre-pass)")
    return qb, kb, vt


def fp8_wgmma_ok(Sq: int, D: int, block_k: int, fp8_native: bool) -> bool:
    """Whether K7 runs on its wgmma kernel: the native route, at least one
    64-row query tile, and two stages of a block_k tile of K and Vᵀ in shared
    memory (``block_k · D <= 32768``). Otherwise its ``mma.sync`` kernel."""
    return fp8_native and Sq >= 64 and block_k * D <= 32768


def _launch_fp8(q, k, v, descale, q_offset, kv_lens, *, causal, window, softcap, scale,
                block_k, out_dtype, fp8_native):
    lib = _build.library("flash_attention_fp8")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    qb = kb = vt = None
    if fp8_wgmma_ok(Sq, D, block_k, fp8_native):
        qb, kb, vt = fp8_prepass(q, k, v)
    out = torch.empty((B, Sq, Hq, D), dtype=out_dtype, device=q.device)
    p = ctypes.c_void_p
    ptr = lambda t: p(t.data_ptr() if t is not None else 0)  # noqa: E731
    err = lib.flash_fp8_launch(
        p(q.data_ptr()), p(k.data_ptr()), p(v.data_ptr()), ptr(qb), ptr(kb), ptr(vt),
        p(out.data_ptr()),
        p(descale[0].data_ptr()), p(descale[1].data_ptr()), p(descale[2].data_ptr()),
        p(q_offset.data_ptr()), p(kv_lens.data_ptr()), ctypes.c_int(B), ctypes.c_int(Sq),
        ctypes.c_int(Sk), ctypes.c_int(vt.shape[-1] if vt is not None else 0),
        ctypes.c_int(Hq), ctypes.c_int(Hk), ctypes.c_int(D),
        ctypes.c_int(block_k), ctypes.c_float(scale), ctypes.c_int(int(causal)),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_int(int(fp8_native)), ctypes.c_int(int(out_dtype == torch.float32)),
        p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(lib, err, "flash_attention_fp8")
    flash_attention_fp8.launches += 1
    return out


def flash_attention_fp8(
    q: torch.Tensor,  # [B, Sq, Hq, D] float8_e4m3fn
    k: torch.Tensor,  # [B, Sk, Hk, D] float8_e4m3fn
    v: torch.Tensor,
    *,
    q_descale,  # [B, Hk], [Hk] or a scalar, float32
    k_descale,
    v_descale,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset=0,
    kv_lens: Optional[torch.Tensor] = None,
    out_dtype=torch.bfloat16,
    fp8_native: Optional[bool] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """FP8-compute flash attention with FA3 descale semantics (forward only):
    scores ``q8·k8 · scale · qd·kd``, P rounded to e4m3 before ``P·V``, the
    V descale in the epilogue. Returns ``out [B, Sq, Hq, D]`` in ``out_dtype``
    (bf16 or float32).

    ``fp8_native`` picks the kernel's route (e4m3 tensor-core products, on
    ``wgmma`` where :func:`fp8_wgmma_ok`, or operands widened to bf16
    exactly); default :func:`..utils.backend.native_fp8_matmul`. The products
    are exact on both, so they differ only in the accumulation; the plain
    version (CPU tensors) has one route. ``block_k`` is the key tile, part of
    the function (default :func:`auto_block` of Sk); ``block_q`` does not
    change the result and is accepted for API parity. Counts kernel launches
    in ``flash_attention_fp8.launches``.
    """
    del block_q
    if not (q.dtype == k.dtype == v.dtype == torch.float8_e4m3fn):
        raise TypeError(f"flash_attention_fp8 takes e4m3 q, k and v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if Hq % Hk or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_fp8 writes bf16 or float32, not {out_dtype}")
    dev = q.device
    if not (k.device == v.device == dev):
        raise ValueError("q, k and v must be on one device")

    def as_bh(d):
        d = torch.as_tensor(d, dtype=torch.float32, device=dev)
        if d.ndim == 0:
            d = d[None]
        if d.ndim == 1:
            d = d[None, :].expand(B, Hk)
        if d.shape != (B, Hk):
            raise ValueError(f"descale of shape {tuple(d.shape)}, want [{B}, {Hk}] or [{Hk}]")
        return d

    descale = torch.stack([as_bh(q_descale), as_bh(k_descale), as_bh(v_descale)]).contiguous()
    q_offset, kv_lens = _per_row(q_offset, kv_lens, B, Sk, dev)
    cfg = dict(causal=causal, window=window, softcap=softcap,
               scale=scale if scale is not None else D ** -0.5,
               block_k=block_k or auto_block(Sk), out_dtype=out_dtype)
    if not q.is_cuda:
        return flash_fp8_plain(q, k, v, descale, q_offset, kv_lens, **cfg)
    if D not in (32, 64, 128):
        raise ValueError(f"head_dim {D} not in (32, 64, 128)")
    if cfg["block_k"] % 64:
        raise ValueError(f"block_k {cfg['block_k']} is not a multiple of 64")
    if fp8_native is None:
        fp8_native = native_fp8_matmul()
    return _launch_fp8(q, k, v, descale, q_offset, kv_lens, fp8_native=fp8_native, **cfg)


flash_attention_fp8.launches = 0
