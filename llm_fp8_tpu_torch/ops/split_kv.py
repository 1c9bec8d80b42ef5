"""Split-KV attention: partial attentions over KV chunks merged by their
log-sum-exps (counterpart of ``llm_fp8_tpu/ops/split_kv.py``).

The KV axis is cut into ``num_splits`` chunks; each chunk attends on its own
through K3's forward with its LSE (``kernels/flash_attention.py::
flash_attention(return_lse=True)``: the kernel on a CUDA tensor, its plain
version on a CPU tensor, so the tensor's device decides what JAX's
``interpret`` argument decided), and :func:`combine_partials` merges the
partials with the online-softmax correction flash applies across tiles.
Chunk i sees the queries at ``q_offset - i·chunk`` (negative for later
chunks) and ``kv_lens`` clipped to ``[0, chunk]``, so a query none of whose
keys lies in the chunk gets LSE -inf there and weighs nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention

__all__ = ["auto_num_splits", "combine_partials", "split_kv_attention"]


def auto_num_splits(batch: int, kv_heads: int, cache_len: int, *,
                    num_cores: Optional[int] = None, min_chunk: int = 1024,
                    max_splits: int = 8) -> int:
    """``num_splits`` from occupancy, JAX's rule: split only when the
    ``batch x kv_heads`` grid cannot occupy ``num_cores`` and the cache holds
    two chunks of ``min_chunk``; then enough splits to fill the cores, at
    most ``cache_len // min_chunk`` and ``max_splits``. JAX reads the TPU's
    core count; ``num_cores=None`` here resolves to 1 (no split), so no
    caller's path changes until a count for the H100 is chosen."""
    if num_cores is None:
        num_cores = 1
    grid = max(1, batch * kv_heads)
    if grid >= num_cores or cache_len < 2 * min_chunk:
        return 1
    want = -(-num_cores // grid)
    return int(min(want, cache_len // min_chunk, max_splits))


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Merge N partial attentions over disjoint KV chunks: ``outs [N, B, Sq,
    Hq, D]`` (each normalized) and ``lses [N, B, Sq, Hq]`` give ``Σ_i w_i ·
    out_i`` with ``w_i = exp(lse_i - max lse) / Σ``; a -inf LSE weighs 0 and a
    row whose every LSE is -inf gives 0. In ``outs``' dtype."""
    m = lses.amax(dim=0, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(torch.isfinite(lses), torch.exp(lses - m_safe), torch.zeros_like(lses))
    denom = w.sum(dim=0)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    num = (w[..., None] * outs.float()).sum(dim=0)
    return (num / denom[..., None]).to(outs.dtype)


def split_kv_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_splits: int,
                       causal: bool = True, scale: Optional[float] = None, q_offset=0,
                       kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of ``q [B, Sq, Hq, D]`` over ``k``/``v [B, Sk, Hk, D]`` as
    ``num_splits`` KV-chunk passes of K3 (``num_splits`` must divide Sk),
    merged by :func:`combine_partials`; one full pass's function. Returns
    ``[B, Sq, Hq, D]`` in q's dtype."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    if Sk % num_splits:
        raise ValueError(f"num_splits={num_splits} must divide the KV length {Sk}")
    chunk = Sk // num_splits
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    q_offset = torch.as_tensor(q_offset, dtype=torch.int32, device=dev).expand(B)
    if kv_lens is None:
        kv_lens = torch.full((B,), Sk, dtype=torch.int32, device=dev)
    kv_lens = kv_lens.to(device=dev, dtype=torch.int32)
    outs, lses = [], []
    for i in range(num_splits):
        # The chunk's keys start at absolute position i·chunk; the queries
        # keep their absolute positions through the offset.
        o_i, lse_i = flash_attention(
            q, k[:, i * chunk:(i + 1) * chunk], v[:, i * chunk:(i + 1) * chunk],
            causal=causal, scale=scale, q_offset=q_offset - i * chunk,
            kv_lens=torch.clamp(kv_lens - i * chunk, 0, chunk), return_lse=True)
        outs.append(o_i.float())
        lses.append(lse_i.transpose(1, 2))  # [B, Sq, Hq]
    return combine_partials(torch.stack(outs), torch.stack(lses)).to(q.dtype)
