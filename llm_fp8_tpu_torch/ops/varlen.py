"""Variable-length batches: padding removal and sequence packing
(counterpart of ``llm_fp8_tpu/ops/varlen.py``).

The JAX package keeps static shapes: :func:`unpad_input` gathers the real
tokens to the front of a stream that keeps all ``B·S`` rows, and
:func:`pack_sequences` packs token sequences into one fixed-length stream
with segment ids, which K3 and K6 (``flash_attention(q_segment_ids=,
kv_segment_ids=)``) and ``attention_ref`` turn into a mask that keeps each
position within its own sequence. The port keeps that contract, so the two
give the same arrays. ``pack_sequences`` and ``cu_seqlens`` stay numpy, as
JAX's are: they run on the host before any tensor exists.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["unpad_input", "pad_input", "pack_sequences", "cu_seqlens"]


def unpad_input(x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x [B, S, ...]`` and ``mask [B, S]`` (nonzero = real token) →
    ``(packed [B·S, ...], indices [B·S], n_tokens)``: the real tokens first,
    in their order, then the padding rows in theirs (the static-size stream
    whose tail callers mask by count; ``indices`` is the gather order)."""
    B, S = mask.shape
    flat = x.reshape(B * S, *x.shape[2:])
    m = mask.reshape(-1).bool()
    order = torch.argsort((~m).to(torch.int8), stable=True)
    return flat[order], order, m.sum()


def pad_input(packed: torch.Tensor, indices: torch.Tensor, batch: int, seqlen: int
              ) -> torch.Tensor:
    """Inverse of :func:`unpad_input`: row i of ``packed`` goes back to flat
    position ``indices[i]`` of ``[batch, seqlen, ...]`` (zeros elsewhere)."""
    flat = packed.new_zeros((batch * seqlen, *packed.shape[1:]))
    flat[indices] = packed
    return flat.reshape(batch, seqlen, *packed.shape[1:])


def cu_seqlens(lens: Sequence[int]) -> np.ndarray:
    """Cumulative offsets ``[0, l0, l0 + l1, ...]`` as int32 (the varlen
    convention of flash attention's ``cu_seqlens``)."""
    return np.concatenate([[0], np.cumsum(np.asarray(lens, np.int32))]).astype(np.int32)


def pack_sequences(seqs: Sequence[np.ndarray], total_len: int, pad_id: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack token sequences into one stream of ``total_len``: ``(tokens,
    segment_ids, positions)``, int32 each. Segment ids count from 1; 0 marks
    the padding tail (tokens ``pad_id``, positions 0). Packing stops at the
    first sequence that does not fit, as JAX's does."""
    tokens = np.full((total_len,), pad_id, np.int32)
    seg = np.zeros((total_len,), np.int32)
    pos = np.zeros((total_len,), np.int32)
    cursor, sid = 0, 1
    for s in seqs:
        n = len(s)
        if cursor + n > total_len:
            break
        tokens[cursor:cursor + n] = s
        seg[cursor:cursor + n] = sid
        pos[cursor:cursor + n] = np.arange(n)
        cursor += n
        sid += 1
    return tokens, seg, pos
