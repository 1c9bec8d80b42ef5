"""Differentiable collectives: what GSPMD inserts in the JAX package, written
out for ``torch.distributed`` with the adjoints the replicated computation
around them needs.

* :func:`gather_shards`: a parameter's shards all-gathered along one dim;
  the backward reduce-scatters (sums) the gradient (FSDP).
* :func:`seq_chunk` / :func:`seq_gather`: the context-parallel island's
  way in and out. Outside attention every ``cp`` rank computes the whole
  sequence, the same on each; ``seq_chunk`` keeps this rank's slice and its
  backward all-gathers the slices' gradients, ``seq_gather`` all-gathers the
  slices and its backward keeps this rank's slice of the (identical)
  gradient. Neither sums over ranks, so gradients come out whole, equal on
  the ``cp`` ranks and not multiplied by their number.
* :func:`replicated_in` / :func:`replicated_sum`: the pipeline island's way
  in (identity; the backward sums the stages' input gradients, only stage 0
  having one) and out (a sum of the stages' outputs, only the last stage's
  non-zero; the backward passes the identical gradient through).
* :func:`hop`: a tensor sent to the next rank of a group and the previous
  rank's received (zeros where there is none); the backward sends the
  gradient the other way.

None for the group makes each an identity; a group of one rank runs the
collectives (a copy).

Serving (tensor-parallel inference, no adjoints): :func:`all_reduce_sum`
(in float32), :func:`all_reduce_max`, :func:`all_gather` along a dim and
:func:`broadcast` from one rank of the group; each is a copy for
``group=None``. Besides a process group they take a :class:`LocalGroup`:
the ranks of a group run as threads of one process (one card, or a CPU
test, doing a tp group's work), where the collectives are rank-ordered
float32 sums, maxima and concatenations.
"""
from __future__ import annotations

import threading
from typing import Callable, List

import torch
import torch.distributed as dist

__all__ = ["gather_shards", "seq_chunk", "seq_gather", "replicated_in", "replicated_sum",
           "hop", "exchange", "group_size", "group_rank", "all_reduce_sum", "all_reduce_max",
           "all_gather", "broadcast", "LocalGroup"]


class LocalGroup:
    """``size`` ranks of one process, each a thread of :meth:`run`. A rank's
    collective hands its tensor in and waits for the others; every rank then
    reads the same rank-ordered result. Ranks on one card share its stream,
    so a tensor handed in is ready for the kernels another rank enqueues
    after the meeting."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size = size
        self._slots: List = [None] * size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._local = threading.local()

    def rank(self) -> int:
        return self._local.rank

    def run(self, fn: Callable[[int], object]) -> list:
        """``[fn(0), ..., fn(size - 1)]``, each on its own thread; the first
        rank's exception is raised (the others' meetings are broken)."""
        out: list = [None] * self.size
        errs: list = [None] * self.size

        def body(r):
            self._local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs[r] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._barrier.reset()
        first = next((e for e in errs if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)), None)
        first = first or next((e for e in errs if e is not None), None)
        if first is not None:
            raise first
        return out

    def meet(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order."""
        self._slots[self.rank()] = t
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()  # nobody hands in the next tensor before all have read
        return parts


def group_size(group) -> int:
    if isinstance(group, LocalGroup):
        return group.size
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    if isinstance(group, LocalGroup):
        return group.rank()
    return 0 if group is None else dist.get_rank(group)


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    t = t.contiguous()
    if isinstance(group, LocalGroup):
        return torch.cat(group.meet(t), dim=dim)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    if dim == 0:
        return out
    return torch.cat(out.view(n, *t.shape).unbind(0), dim=dim)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group`` of ``t``, in float32 (a new
    tensor; ``t`` unchanged). A bf16 partial is widened first, so the sum
    rounds once, where the caller casts it."""
    out = t.float() if t.dtype != torch.float32 else t.clone()
    if group is None:
        return out
    if isinstance(group, LocalGroup):
        parts = group.meet(out)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc
    dist.all_reduce(out, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the ranks of ``group`` (a new tensor)."""
    if group is None:
        return t.clone()
    if isinstance(group, LocalGroup):
        return torch.stack(group.meet(t)).amax(dim=0)
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order."""
    if group is None:
        return t.clone()
    return _all_gather(t, dim % t.ndim, group)


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src`` (of the group)'s ``t`` on every rank of ``group``; the
    others pass a tensor of the same shape and dtype."""
    if group is None:
        return t.clone()
    if isinstance(group, LocalGroup):
        return group.meet(t)[src].clone()
    out = t.contiguous().clone()
    dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
    return out


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    parts = g.chunk(n, dim=dim)
    flat = g.contiguous() if dim == 0 else torch.cat([p.contiguous() for p in parts])
    out = g.new_empty(parts[0].shape)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def gather_shards(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards ``t`` of the ranks of ``group`` concatenated along ``dim``
    in rank order; the gradient is reduce-scattered back (summed over the
    ranks). A group of one rank still goes through the collectives."""
    if group is None:
        return t
    return _GatherShards.apply(t, dim, group)


class _SeqChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return t.chunk(group_size(group), dim=dim)[group_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(group_size(ctx.group), dim=ctx.dim)[group_rank(ctx.group)].contiguous(), \
            None, None


def seq_chunk(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``t`` (equal on every rank of ``group``) along
    ``dim``; backward: the slices' gradients all-gathered."""
    if group_size(group) == 1:
        return t
    if t.shape[dim] % group_size(group):
        raise ValueError(f"context parallelism: length {t.shape[dim]} is not a multiple of "
                         f"the {group_size(group)} ranks")
    return _SeqChunk.apply(t, dim, group)


def seq_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' slices concatenated along ``dim``; backward: this rank's
    slice of the gradient."""
    if group_size(group) == 1:
        return t
    return _SeqGather.apply(t, dim, group)


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_in(t: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the ranks' gradients (the gradient of a
    value every rank holds, used by some of them)."""
    return t if group_size(group) == 1 else _ReplicatedIn.apply(t, group)


def replicated_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group``; the backward passes the gradient
    through unchanged (every rank goes on with the same sum)."""
    return t if group_size(group) == 1 else _ReplicatedSum.apply(t, group)


def exchange(t, group, *, shift: int = 1, wrap: bool = True):
    """``t`` (a tensor or a list of them) sent to the rank ``shift`` places
    on in ``group``, and what the rank ``shift`` places back sent, received
    (one ``batch_isend_irecv`` for the lot). ``wrap=False``: no wrap-around;
    an end rank sends or receives nothing and receives zeros."""
    single = isinstance(t, torch.Tensor)
    ts = [t] if single else list(t)
    n, r = group_size(group), group_rank(group)
    recv = [torch.empty_like(x) for x in ts]
    dst, src = r + shift, r - shift
    ops = []
    if n > 1 and (wrap or 0 <= dst < n):
        peer = dist.get_global_rank(group, dst % n)
        ops += [dist.P2POp(dist.isend, x.contiguous(), peer, group) for x in ts]
    if n > 1 and (wrap or 0 <= src < n):
        peer = dist.get_global_rank(group, src % n)
        ops += [dist.P2POp(dist.irecv, x, peer, group) for x in recv]
    elif n == 1 and wrap:
        recv = [x.clone() for x in ts]
    else:
        for x in recv:
            x.zero_()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv[0] if single else recv


class _Hop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return exchange(t, group, shift=1, wrap=False)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group, shift=-1, wrap=False), None


def hop(t: torch.Tensor, group) -> torch.Tensor:
    """One step down a chain of ranks: ``t`` to the next rank, the previous
    rank's tensor back (zeros at the first); the gradient goes up."""
    return _Hop.apply(t, group)
