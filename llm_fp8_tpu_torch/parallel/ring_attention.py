"""Ring attention: context parallelism over a process group, trainable
(counterpart of ``llm_fp8_tpu/parallel/ring_attention.py``).

Each rank holds one chunk of the sequence's queries and one of its keys and
values. The K/V chunks travel round the ring (rank r sends to r + 1) while
each rank runs K3 (``kernels/flash_attention.py::flash_attention`` with its
LSE; its plain version on CPU tensors) on its queries against the chunk in
front of it, at the *relative* ``q_offset = idx·Sq − src·Sk`` that puts the
kernel's causal and window compares in absolute coordinates; the partial
outputs merge in float32 by the online-softmax combine, with JAX's guards
for ``-inf``. The backward is a second ring: every step runs K6
(``kernels/flash_attention_bwd.py::flash_attention_bwd``) with the final
output, the *global* LSE and ``dO``, so each step's gradients are exact
parts that add up (K6's dQ kernel takes ``di`` from the final output, as the
global softmax needs); dQ accumulates in float32 on its rank, the dK/dV
accumulators ride the ring with their chunk and take one final hop home.

A chunk no query of this rank can see (wholly in the future under causal,
or behind every query's window) launches nothing, forward or backward: the
port has no jit shape constraint, and an absent partial weighs 0 in the
merge, as a ``-inf`` LSE would. Ragged batches: ``kv_lens`` are absolute
lengths, each chunk takes ``clip(kv_lens − src·Sk, 0, Sk)``. Dropout and
ALiBi are refused (``ops/attention.py`` raises), as in JAX.

The step functions (:func:`chunk_schedule`, :func:`step_args`,
:func:`fwd_partial`, :class:`OnlineMerge`, :func:`bwd_partial`) are what
the distributed ring calls at each (rank, step); ``chip_smoke.py`` runs a
ring of 4 in one process through them, the hop a rotation of a list.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention_bwd import flash_attention_bwd
from .collectives import exchange, group_rank, group_size

__all__ = ["ring_attention", "RingSpec", "chunk_schedule", "step_args", "fwd_partial",
           "OnlineMerge", "bwd_partial"]


@dataclasses.dataclass(frozen=True)
class RingSpec:
    """The attention's function: causal, the logit scale, a sliding window,
    a softcap."""

    causal: bool
    scale: float
    window: Optional[int] = None
    softcap: Optional[float] = None


def chunk_schedule(step: int, idx: int, Sq: int, Sk: int, n: int, causal: bool,
                   window: Optional[int]) -> Tuple[int, int, bool]:
    """``(src, q_offset, dead)`` of the chunk rank ``idx`` holds at ``step``:
    the rank it came from, the relative offset (``q_abs = idx·Sq + i``,
    ``k_abs = src·Sk + j``), and whether no query here can see it."""
    src = (idx - step) % n
    q_offset = idx * Sq - src * Sk
    dead = causal and src * Sk > idx * Sq + Sq - 1
    if window is not None:
        dead = dead or src * Sk + Sk - 1 <= idx * Sq - window
    return src, q_offset, dead


def step_args(step: int, idx: int, n: int, q_shape, k_shape, kv_lens: Optional[torch.Tensor],
              spec: RingSpec, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The kernels' per-batch-row ``(q_offset, kv_lens)`` int32 tensors on
    ``device`` for this (rank, step), or None for a dead chunk."""
    B, Sq = q_shape[:2]
    Sk = k_shape[1]
    src, q_offset, dead = chunk_schedule(step, idx, Sq, Sk, n, spec.causal, spec.window)
    if dead:
        return None
    qo = torch.full((B,), q_offset, dtype=torch.int32, device=device)
    if kv_lens is None:
        return qo, torch.full((B,), Sk, dtype=torch.int32, device=device)
    lens = (kv_lens.to(device=device, dtype=torch.int64) - src * Sk).clamp(0, Sk)
    return qo, lens.to(torch.int32)


def fwd_partial(q, k_blk, v_blk, args, spec: RingSpec):
    """K3 on this rank's queries against one chunk: ``(out [B, Sq, Hq, D],
    lse [B, Hq, Sq] float32)``; rows with no live key give 0 and ``-inf``."""
    return flash_attention(q, k_blk, v_blk, causal=spec.causal, window=spec.window,
                           softcap=spec.softcap, scale=spec.scale, q_offset=args[0],
                           kv_lens=args[1], return_lse=True)


class OnlineMerge:
    """The partials' running combine in float32 (JAX's ``_ring_forward``):
    ``m`` the largest LSE so far, ``l`` the weights' sum, ``acc`` the
    weighted outputs; ``[B, Hq, Sq]`` for the row statistics."""

    def __init__(self, q: torch.Tensor):
        B, Sq, Hq, D = q.shape
        self.m = torch.full((B, Hq, Sq), -float("inf"), dtype=torch.float32, device=q.device)
        self.l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
        self.acc = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=q.device)

    def add(self, out_p: torch.Tensor, lse_p: torch.Tensor) -> None:
        m_new = torch.maximum(self.m, lse_p)
        safe = torch.isfinite(m_new)
        base = torch.where(safe, m_new, torch.zeros_like(m_new))
        alpha = torch.where(safe, torch.exp(self.m - base), torch.zeros_like(m_new))
        beta = torch.where(torch.isfinite(lse_p), torch.exp(lse_p - base),
                           torch.zeros_like(m_new))
        self.acc = (self.acc * alpha.transpose(1, 2)[..., None]
                    + out_p.float() * beta.transpose(1, 2)[..., None])
        self.l = self.l * alpha + beta
        self.m = m_new

    def finish(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out in dtype, the global LSE [B, Hq, Sq])``; a row no chunk
        reached gives 0 and ``-inf``."""
        empty = self.l == 0.0
        l_inv = torch.where(empty, torch.ones_like(self.l), 1.0 / self.l)
        out = (self.acc * l_inv.transpose(1, 2)[..., None]).to(dtype)
        lse = self.m + torch.log(torch.where(empty, torch.ones_like(self.l), self.l))
        return out, lse.contiguous()


def bwd_partial(q, k_blk, v_blk, out, lse, do, args, spec: RingSpec):
    """K6 on one chunk with the final ``out`` and the global ``lse``:
    ``(dq, dk, dv)``, this chunk's exact parts."""
    return flash_attention_bwd(q, k_blk, v_blk, out, lse, do, causal=spec.causal,
                               window=spec.window, softcap=spec.softcap, scale=spec.scale,
                               q_offset=args[0], kv_lens=args[1])


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, group, spec):
        n, idx = group_size(group), group_rank(group)
        merge = OnlineMerge(q)
        k_blk, v_blk = k, v
        for step in range(n):
            args = step_args(step, idx, n, q.shape, k.shape, kv_lens, spec, q.device)
            if args is not None:
                merge.add(*fwd_partial(q, k_blk, v_blk, args, spec))
            if step < n - 1:
                k_blk, v_blk = exchange([k_blk, v_blk], group)
        out, lse = merge.finish(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.group, ctx.spec = group, spec
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        group, spec = ctx.group, ctx.spec
        n, idx = group_size(group), group_rank(group)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_blk, v_blk = k, v
        for step in range(n):
            args = step_args(step, idx, n, q.shape, k.shape, kv_lens, spec, q.device)
            if args is not None:
                dq_p, dk_p, dv_p = bwd_partial(q, k_blk, v_blk, out, lse, do, args, spec)
                dq += dq_p.float()
                dk += dk_p.float()
                dv += dv_p.float()
            if step < n - 1:
                k_blk, v_blk, dk, dv = exchange([k_blk, v_blk, dk, dv], group)
        # After n - 1 hops the accumulator of rank c's chunk sits on rank
        # c - 1: one more hop takes it home.
        dk, dv = exchange([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                   causal: bool = True, scale: Optional[float] = None,
                   window: Optional[int] = None, softcap: Optional[float] = None,
                   kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Context-parallel attention of one rank: ``q [B, Sq, Hq, D]`` its
    query chunk, ``k``/``v [B, Sk, Hk, D]`` its KV chunk (chunk ``r`` of the
    sequence on rank ``r`` of ``group``); returns its output chunk.
    Differentiable in q, k and v. ``kv_lens``: ``[B]`` absolute valid
    lengths of the whole sequence."""
    spec = RingSpec(causal=causal, scale=scale if scale is not None else q.shape[-1] ** -0.5,
                    window=window, softcap=softcap)
    if kv_lens is not None:
        kv_lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int32)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_lens, group, spec)
