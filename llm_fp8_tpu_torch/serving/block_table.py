"""Paged-KV block tables: host-side allocator and per-sequence tables.

Counterpart of ``llm_fp8_tpu/serving/block_table.py``, with the same API and
the same block-id order. The allocator is the native C++ free list with
reference counts (the repo's ``csrc/block_allocator.cpp``, the source the
JAX package builds too), built with g++ into
``_build/`` at first use and loaded with ctypes; a failed build raises with
the compiler's output. The device half is the paged decode kernel K5
(``kernels/paged_attention.py``).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from ..kernels import _build

__all__ = ["BlockAllocator", "SequenceTable"]

_I32 = ctypes.c_int32
_I32P = ctypes.POINTER(ctypes.c_int32)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.library("block_allocator")
        for fn, res, args in (
                ("ba_create", ctypes.c_void_p, [_I32, _I32]),
                ("ba_destroy", None, [ctypes.c_void_p]),
                ("ba_num_free", _I32, [ctypes.c_void_p]),
                ("ba_alloc", _I32, [ctypes.c_void_p, _I32, _I32P]),
                ("ba_release", None, [ctypes.c_void_p, _I32, _I32P]),
                ("ba_fork", _I32, [ctypes.c_void_p, _I32, _I32P]),
                ("ba_refcount", _I32, [ctypes.c_void_p, _I32])):
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        _lib = lib
    return _lib


def _ids(blocks) -> ctypes.Array:
    blocks = np.asarray(blocks, np.int32).reshape(-1)
    return (ctypes.c_int32 * max(len(blocks), 1))(*blocks.tolist()), len(blocks)


class BlockAllocator:
    """Free-list block allocator with reference counts (native C++).

    Block 0 is handed out first; released blocks are reused last-in,
    first-out."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._lib = _load()
        self._h = self._lib.ba_create(num_blocks, block_size)
        if not self._h:
            raise ValueError(f"allocator create failed ({num_blocks} blocks of {block_size})")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ba_destroy(self._h)
            self._h = None

    @property
    def num_free(self) -> int:
        return int(self._lib.ba_num_free(self._h))

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """Allocate n blocks; None if not enough are free (all-or-nothing)."""
        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.ba_alloc(self._h, n, out) != 0:
            return None
        return np.frombuffer(out, dtype=np.int32, count=n).copy()

    def release(self, blocks) -> None:
        """Drop one reference on each block; unknown or free blocks are ignored."""
        arr, n = _ids(blocks)
        self._lib.ba_release(self._h, n, arr)

    def fork(self, blocks) -> bool:
        """Share blocks (prefix caching): one more reference on each. False
        (and nothing changed) if any block is not allocated."""
        arr, n = _ids(blocks)
        return self._lib.ba_fork(self._h, n, arr) == 0

    def refcount(self, block: int) -> int:
        return int(self._lib.ba_refcount(self._h, block))


class SequenceTable:
    """Per-sequence block table growing as the sequence decodes."""

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.blocks: List[int] = []
        self.length = 0  # tokens

    def ensure_capacity(self, n_tokens: int) -> bool:
        """Grow the table to hold n_tokens; False if the pool is exhausted."""
        bs = self.allocator.block_size
        need = -(-n_tokens // bs) - len(self.blocks)
        if need > 0:
            got = self.allocator.alloc(need)
            if got is None:
                return False
            self.blocks.extend(got.tolist())
        self.length = max(self.length, n_tokens)
        return True

    def table(self, max_blocks: int) -> np.ndarray:
        """Fixed-width block table row (padded with 0) for the device kernel."""
        out = np.zeros((max_blocks,), np.int32)
        out[: len(self.blocks)] = self.blocks
        return out

    def free(self):
        if self.blocks:
            self.allocator.release(np.asarray(self.blocks, np.int32))
            self.blocks = []
            self.length = 0
