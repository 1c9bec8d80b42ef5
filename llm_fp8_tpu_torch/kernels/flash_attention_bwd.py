"""K6: flash-attention backward (dQ, dK, dV) over bshd tensors.

Counterpart of ``llm_fp8_tpu/kernels/flash_attention_bwd.py::flash_attention_bwd``
(``_dkv_kernel``, ``_dq_kernel``, ``_recompute_p_and_ds``). On CUDA tensors
:func:`flash_attention_bwd` launches the two kernels of
``csrc/flash_attention_bwd.cu`` (dQ, then dKV); on CPU tensors it takes
:func:`flash_attention_bwd_plain`. Both kernels load their tiles through TMA
into a ring of shared memory and run all five products on Hopper's
``wgmma``, with the score tiles, p and ds in registers; neither uses
atomics, so two runs give the same bits. At head dim 256 (Gemma-2) the dQ
kernel takes 64-query tiles and the dKV kernel's grid splits D's columns
over two blocks, each recomputing the whole score tile.

The softmax weights are recomputed from the forward's log-sum-exp, which is
K3's ``[B, Hq, Sq]`` here (the TPU's is ``[B, Hq, 8, Sq_p]``). Rows whose LSE
is ``-inf`` (no live key) get p = 0, not NaN. p and ds are rounded to q's
dtype (bf16 here; float32 in the float32 instance) before the dV, dK and
dQ products, and the GQA group sum of dK/dV runs in float32, as in the TPU
kernel (its module docstring says the sum happens outside the kernel; the
code does it inside). ``di = rowsum(o·do)``, which
JAX leaves to XLA, is computed by the dQ kernel on the card (so dQ runs
first) and by :func:`row_di` in the plain version. Causal with a per-batch
``q_offset``, ``kv_lens``, GQA, sliding window, softcap, the logit scale,
ALiBi and attention dropout are supported: the ALiBi bias is additive, so
the recomputed scores carry it and the dS chain is unchanged (the softcap
derivative reads the unbiased capped score); dropout rebuilds the forward's
keep mask from the same counter hash (``csrc/dropout.cuh``), feeds the
kept and scaled p to dV and masks dP, while dS uses the undropped p and
``di`` (``o`` is the dropped output). ``attention_chunk`` and segment ids
mask as in the forward (``_common.live_mask``; the EXTRA instances on the
card, which skip the tiles outside every row's chunk).

float32 q/k/v (the GPT-2 and NeoX families train in float32) take K6's
float32 instance on the card, :func:`flash_attention_bwd_f32`
(``csrc/flash_attention_bwd_f32.cu``: the same two kernels on ``wgmma``
TF32 products with a 3xTF32 split, so float32 accuracy, each tile's operands
split once into shared-memory planes; the dKV walk splits a GQA group into
the slices of :func:`dkv_slices`, summed in slice order; p and ds stay
float32, as the TPU kernel keeps them in q's dtype; head dims 32, 64, 80,
128 and 256; causal, ``q_offset``, ``kv_lens``, GQA, the scale, ALiBi and
dropout; no window, softcap, chunk or segment ids on the card).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._common import (PADDED_HEAD_DIMS, aligned16, alibi_bias, dropout_args, dropout_inv,
                      dropout_keep, f32_card_refuses, live_mask, pad_head_dim)

__all__ = ["flash_attention_bwd", "flash_attention_bwd_plain", "flash_bwd_dkv",
           "flash_bwd_dq", "recompute_p_ds", "row_di", "flash_attention_bwd_f32",
           "flash_bwd_f32_dq", "flash_bwd_f32_dkv", "F32_HEAD_DIMS", "dkv_slices",
           "dkv_scratch_shape", "dkv_keys", "DKV_TARGET_BLOCKS"]

#: Head dims of the float32 instance: K3's float32 instance's (GPT-2/OPT/
#: Falcon 64, SantaCoder and Pythia-1.4B 128, BTLM 80, GPT-J 256, debug 32).
F32_HEAD_DIMS = (32, 64, 80, 128, 256)


def row_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(o·do)`` in float32, ``[B, Hq, Sq]``."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


def recompute_p_ds(q, k, v, lse, do, di, q_offset, kv_lens, *, causal: bool,
                   window: Optional[int], softcap: Optional[float], scale: float,
                   alibi=None, dropout_p: float = 0.0, dropout_seed=0,
                   attention_chunk=None, q_segment_ids=None, kv_segment_ids=None):
    """p (as applied to V in the forward: kept and scaled under dropout) and
    ds ``[B, Hq, Sq, Sk]`` in float32 (before their rounding to q's dtype),
    the TPU kernel's ``_recompute_p_and_ds`` over the whole score matrix."""

    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    z = softcap * torch.tanh(s / softcap) if softcap is not None else s
    z_b = z + alibi_bias(alibi, q_offset, Sq, Sk) if alibi is not None else z
    mask = live_mask(q_offset, kv_lens, Sq, Sk, causal=causal, window=window,
                     attention_chunk=attention_chunk, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids)
    finite = torch.isfinite(lse)[..., None]
    lse0 = torch.where(finite, lse[..., None], torch.zeros_like(lse[..., None]))
    p = torch.where(mask[:, None] & finite, torch.exp(z_b - lse0), torch.zeros_like(z))
    dp = do.float().permute(0, 2, 1, 3) @ vf.transpose(-1, -2)
    p_v = p
    if dropout_p > 0.0:
        keep = dropout_keep(dropout_seed, dropout_p, q_offset, B, Hq, Sq, Sk)
        inv = dropout_inv(dropout_p)
        p_v = torch.where(keep, p, torch.zeros_like(p)) * inv
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    ds = p * (dp - di[..., None])
    if softcap is not None:
        ds = ds * (1.0 - (z / softcap) ** 2)
    return p_v, ds * scale


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool, window: Optional[int],
                              softcap: Optional[float], scale: float, q_offset, kv_lens,
                              alibi=None, dropout_p: float = 0.0, dropout_seed=0,
                              attention_chunk=None, q_segment_ids=None, kv_segment_ids=None):
    """The kernels' function in plain PyTorch. Returns ``dq, dk, dv`` (bshd,
    in q's, k's and v's dtypes)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    g = Hq // Hk
    p, ds = recompute_p_ds(q, k, v, lse, do, row_di(o, do), q_offset, kv_lens,
                           causal=causal, window=window, softcap=softcap, scale=scale,
                           alibi=alibi, dropout_p=dropout_p, dropout_seed=dropout_seed,
                           attention_chunk=attention_chunk, q_segment_ids=q_segment_ids,
                           kv_segment_ids=kv_segment_ids)
    # p and ds in q's dtype for the products (the TPU kernel's ``astype(q.dtype)``):
    # bf16 for the bf16 kernel, float32 for the float32 instance.
    pb = p.to(q.dtype).float()
    dsb = ds.to(q.dtype).float()
    qf = q.float().permute(0, 2, 1, 3)
    dof = do.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    dv = (pb.transpose(-1, -2) @ dof).reshape(B, Hk, g, Sk, D).sum(dim=2)
    dk = (dsb.transpose(-1, -2) @ qf).reshape(B, Hk, g, Sk, D).sum(dim=2)
    dq = dsb @ kf

    def bshd(t, dtype):
        return t.permute(0, 2, 1, 3).to(dtype).contiguous()

    return bshd(dq, q.dtype), bshd(dk, k.dtype), bshd(dv, v.dtype)


def _common_args(q, k, cfg):
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]

    def ptr(key):
        t = cfg.get(key)
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    return [ptr("alibi"), ptr("q_segment_ids"), ptr("kv_segment_ids"),
            ctypes.c_int(B), ctypes.c_int(Sq), ctypes.c_int(Sk), ctypes.c_int(Hq),
            ctypes.c_int(Hk), ctypes.c_int(D), ctypes.c_float(cfg["scale"]),
            ctypes.c_int(int(cfg["causal"])), ctypes.c_int(cfg["window"] or 0),
            ctypes.c_float(cfg["softcap"] or 0.0), ctypes.c_int(cfg.get("attention_chunk") or 0),
            *dropout_args(cfg.get("dropout_p", 0.0), cfg.get("dropout_seed", 0)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)]


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def flash_bwd_dkv(q, k, v, do, lse, di, q_offset, kv_lens, **cfg):
    """dK and dV on the card (the dKV kernel); counts its launches."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_attention_bwd")
    err = lib.flash_bwd_dkv_launch(*_ptrs(q, k, v, do, lse, di, q_offset, kv_lens, dk, dv),
                                   *_common_args(q, k, cfg))
    _build.check(lib, err, "flash_attention_bwd (dKV)")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, o, do, lse, q_offset, kv_lens, **cfg):
    """dQ on the card (the dQ kernel), which also computes ``di =
    rowsum(o·do)`` (float32 ``[B, Hq, Sq]``) for the dKV kernel; counts its
    launches. Returns ``(dq, di)``."""
    B, Sq, Hq, _ = q.shape
    dq = torch.empty_like(q)
    di = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd")
    err = lib.flash_bwd_dq_launch(*_ptrs(q, k, v, o, do, lse, di, q_offset, kv_lens, dq),
                                  *_common_args(q, k, cfg))
    _build.check(lib, err, "flash_attention_bwd (dQ)")
    flash_bwd_dq.launches += 1
    return dq, di


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, window: Optional[int],
                        softcap: Optional[float], scale: float, q_offset: torch.Tensor,
                        kv_lens: torch.Tensor, alibi: Optional[torch.Tensor] = None,
                        dropout_p: float = 0.0, dropout_seed=0,
                        attention_chunk: Optional[int] = None,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None):
    """``dq, dk, dv`` of flash attention from the forward's ``o`` and ``lse``
    (``[B, Hq, Sq]`` float32) and the output gradient ``do``. ``q_offset``
    and ``kv_lens`` are int32 ``[B]`` tensors on q's device; ``alibi`` the
    float32 ``[B, Hq]`` slopes or None; ``dropout_p``/``dropout_seed``,
    ``attention_chunk`` and the int32 segment ids (``[B, Sq]``, ``[B, Sk]``)
    the forward's. On the card a head dim of 16, 24 or 192 runs zero-padded
    to the 32 or 256 instance (``PADDED_HEAD_DIMS``) and dq, dk, dv are
    sliced back (the autograd path pads before the forward, so it arrives
    padded)."""
    cfg = dict(causal=causal, window=window, softcap=softcap, scale=scale, alibi=alibi,
               dropout_p=dropout_p, dropout_seed=dropout_seed, attention_chunk=attention_chunk,
               q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    D = q.shape[-1]
    if q.is_cuda and D in PADDED_HEAD_DIMS:  # onto the padded instance, as the forward
        Dp = PADDED_HEAD_DIMS[D]
        q, k, v, o, do = (pad_head_dim(t, Dp) for t in (q, k, v, o, do))
        return tuple(g[..., :D] for g in flash_attention_bwd(
            q, k, v, o, lse, do, q_offset=q_offset, kv_lens=kv_lens, **cfg))
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, q_offset=q_offset,
                                         kv_lens=kv_lens, **cfg)
    if q.dtype == torch.float32:
        return flash_attention_bwd_f32(q, k, v, o, lse, do, q_offset=q_offset,
                                       kv_lens=kv_lens, **cfg)
    B, Sq, Hq, D = q.shape
    if D not in (32, 64, 128, 256) or q.dtype != torch.bfloat16 or do.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_bwd: bf16 with head_dim 32/64/128/256 (16/24/192 "
                         f"padded), got {q.dtype} D={D}, do {do.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 {(B, Hq, Sq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, do = (aligned16(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, di = flash_bwd_dq(q, k, v, o, do, lse, q_offset, kv_lens, **cfg)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, q_offset, kv_lens, **cfg)
    return dq, dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def _f32_args(q, k, cfg, nslices=None):
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    alibi = cfg.get("alibi")
    return [ctypes.c_void_p(alibi.data_ptr() if alibi is not None else 0),
            ctypes.c_int(B), ctypes.c_int(Sq), ctypes.c_int(Sk), ctypes.c_int(Hq),
            ctypes.c_int(Hk), ctypes.c_int(D),
            *([] if nslices is None else [ctypes.c_int(nslices)]),
            ctypes.c_float(cfg["scale"]),
            ctypes.c_int(int(cfg["causal"])), ctypes.c_int(cfg.get("passes", 3)),
            *dropout_args(cfg.get("dropout_p", 0.0), cfg.get("dropout_seed", 0)),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)]


#: The blocks :func:`dkv_slices` aims the float32 dKV grid at: sixteen for
#: each of the H100's 132 SMs. The causal walk's blocks are uneven (a key
#: tile near the start meets every query, one near the end few), and on an
#: H100 more, smaller blocks evened them out up to one q head a slice
#: (``scripts/kernel_variants.py k6-f32-slices``): SantaCoder's dKV (B 4 x
#: S 1024, 16 q heads over one) took 5776 µs in one slice, 1234 in 8 and
#: 1008 in 16; Falcon-7B's training shape (B 8 x S 512, 71 over one) 6279 in
#: one and 1079 in 71.
DKV_TARGET_BLOCKS = 16 * 132


def dkv_keys(D: int) -> int:
    """Keys a block of the float32 dKV kernel takes (``Rows<D, kDKV>::BM``:
    two warpgroups of 64 at head dims 80 and 128, one at 32, 64 and 256)."""
    return 128 if D in (80, 128) else 64


def dkv_slices(B: int, Sk: int, Hk: int, group: int, D: int) -> int:
    """Slices of each GQA group that the float32 dKV kernel splits its walk
    into: the fewest that divide ``group`` and bring its grid of key tiles
    (:func:`dkv_keys`; two blocks a tile at D 256, dK's and dV's), kv heads
    and batch rows to :data:`DKV_TARGET_BLOCKS` blocks, or the group itself.
    Slice s of n takes the group's q heads ``s·group // n .. (s + 1)·group //
    n - 1`` (as many in each); the slices' partial dK and dV are summed in
    slice order."""
    tiles = -(-Sk // dkv_keys(D)) * (2 if D == 256 else 1)
    want = -(-DKV_TARGET_BLOCKS // (tiles * Hk * B))
    return next(n for n in range(1, group + 1) if group % n == 0 and (n >= want or n == group))


def dkv_scratch_shape(B: int, Sk: int, Hk: int, D: int, nslices: int) -> tuple:
    """The float32 partials a split walk writes: dK's and dV's, one
    ``[B, Sk, Hk, D]`` each per slice."""
    return (2, nslices, B, Sk, Hk, D)


def flash_bwd_f32_dq(q, k, v, o, do, lse, q_offset, kv_lens, **cfg):
    """dQ of K6's float32 instance on the card (its dQ kernel), which also
    computes ``di = rowsum(o·do)`` (float32 ``[B, Hq, Sq]``) for the dKV
    kernel; counts its launches. Returns ``(dq, di)``."""
    B, Sq, Hq, _ = q.shape
    dq = torch.empty_like(q)
    di = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd_f32")
    err = lib.flash_bwd_f32_dq_launch(*_ptrs(q, k, v, o, do, lse, di, q_offset, kv_lens, dq),
                                      *_f32_args(q, k, cfg))
    _build.check(lib, err, "flash_attention_bwd_f32 (dQ)")
    flash_bwd_f32_dq.launches += 1
    return dq, di


def dkv_partials_launch(q, k, v, do, lse, di, q_offset, kv_lens, out_k, out_v, nslices,
                        **cfg):
    """The float32 dKV kernel alone over ``nslices`` slices of each group:
    ``out_k``/``out_v`` are ``[nslices, B, Sk, Hk, D]`` float32 (for one
    slice, dk and dv themselves). Counts nothing: :func:`flash_bwd_f32_dkv`
    is the kernel's wrapper."""
    lib = _build.library("flash_attention_bwd_f32")
    err = lib.flash_bwd_f32_dkv_launch(
        *_ptrs(q, k, v, do, lse, di, q_offset, kv_lens, out_k, out_v),
        *_f32_args(q, k, cfg, nslices))
    _build.check(lib, err, "flash_attention_bwd_f32 (dKV)")


def dkv_sum_launch(parts, dk, dv):
    """dk, dv = the sums of the slices' partials ``parts`` (the shape of
    :func:`dkv_scratch_shape`) in slice order: the dKV kernel's second pass."""
    if dk.numel() >= 2 ** 31:
        raise ValueError(f"flash_attention_bwd_f32: {dk.numel()} elements of dK")
    lib = _build.library("flash_attention_bwd_f32")
    err = lib.flash_bwd_f32_dkv_sum_launch(
        *_ptrs(parts, dk, dv), ctypes.c_int(dk.numel()), ctypes.c_int(parts.shape[1]),
        ctypes.c_void_p(torch.cuda.current_stream(dk.device).cuda_stream))
    _build.check(lib, err, "flash_attention_bwd_f32 (dKV sum)")


def flash_bwd_f32_dkv(q, k, v, do, lse, di, q_offset, kv_lens, **cfg):
    """dK and dV of K6's float32 instance on the card (its dKV kernel, over
    the slices of :func:`dkv_slices`, then the slices' sum where there are
    several); counts its launches."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    n = dkv_slices(B, Sk, Hk, Hq // Hk, D)
    if n == 1:
        dkv_partials_launch(q, k, v, do, lse, di, q_offset, kv_lens, dk, dv, 1, **cfg)
    else:
        parts = torch.empty(dkv_scratch_shape(B, Sk, Hk, D, n), dtype=torch.float32,
                            device=q.device)
        dkv_partials_launch(q, k, v, do, lse, di, q_offset, kv_lens, parts[0], parts[1], n,
                            **cfg)
        dkv_sum_launch(parts, dk, dv)
    flash_bwd_f32_dkv.launches += 1
    return dk, dv


flash_bwd_f32_dq.launches = 0
flash_bwd_f32_dkv.launches = 0


def flash_attention_bwd_f32(q, k, v, o, lse, do, *, causal: bool, scale: float,
                            q_offset: torch.Tensor, kv_lens: torch.Tensor,
                            alibi: Optional[torch.Tensor] = None, dropout_p: float = 0.0,
                            dropout_seed=0, window: Optional[int] = None,
                            softcap: Optional[float] = None, attention_chunk=None,
                            q_segment_ids=None, kv_segment_ids=None, passes: int = 3):
    """K6's float32 instance: ``dq, dk, dv`` of float32 attention, the
    arguments of :func:`flash_attention_bwd`. On CUDA tensors it launches
    the dQ kernel (which writes di) and then the dKV kernel, and raises on
    what they do not take (another dtype or head dim, a window, a softcap, a
    chunk, segment ids); on CPU tensors it takes
    :func:`flash_attention_bwd_plain`. ``passes=1`` runs the products in
    single-pass TF32 (the planted fault of the card's checks)."""
    cfg = dict(causal=causal, scale=scale, alibi=alibi, dropout_p=dropout_p,
               dropout_seed=dropout_seed)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, q_offset=q_offset,
                                         kv_lens=kv_lens, window=window, softcap=softcap,
                                         attention_chunk=attention_chunk,
                                         q_segment_ids=q_segment_ids,
                                         kv_segment_ids=kv_segment_ids, **cfg)
    B, Sq, Hq, D = q.shape
    if not all(t.dtype == torch.float32 for t in (q, k, v, o, do)):
        raise TypeError(f"flash_attention_bwd_f32 takes float32 q, k, v, o and do, got "
                        f"{[str(t.dtype) for t in (q, k, v, o, do)]}")
    if D not in F32_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_f32: head_dim {D} not in {F32_HEAD_DIMS}")
    f32_card_refuses(window, softcap, attention_chunk, q_segment_ids)
    if passes not in (1, 3):
        raise ValueError(f"passes {passes} is not 1 or 3")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_f32: lse must be float32 {(B, Hq, Sq)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, do = (aligned16(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, di = flash_bwd_f32_dq(q, k, v, o, do, lse, q_offset, kv_lens, passes=passes, **cfg)
    dk, dv = flash_bwd_f32_dkv(q, k, v, do, lse, di, q_offset, kv_lens, passes=passes, **cfg)
    return dq, dk, dv
