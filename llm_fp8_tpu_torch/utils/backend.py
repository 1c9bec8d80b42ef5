"""Backend capability detection and device resolution.

Counterpart of ``llm_fp8_tpu/utils/backend.py``: the TPU version parses the
TPU generation; here the card's compute capability decides. fp8 tensor cores
exist from sm_89 (Ada) on, so ``"auto"`` KV is e4m3 on such cards.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch

__all__ = ["device_kind", "native_fp8_matmul", "resolve_kv_dtype",
           "resolve_device", "CARD_PEAKS", "card_peaks"]

#: Published peaks (NVIDIA data sheets, dense): device memory bytes/s and
#: bf16 tensor-core FLOP/s, by a substring of the card's name; the first
#: match wins.
CARD_PEAKS = (("H100 NVL", 3.9e12, 835e12), ("H100 PCIe", 2.0e12, 756e12),
              ("H200", 4.8e12, 989e12), ("H100", 3.35e12, 989e12))


def card_peaks(name: str) -> Optional[Tuple[float, float]]:
    """``(bytes/s, bf16 FLOP/s)`` of the card ``name`` (as
    ``torch.cuda.get_device_name`` gives it), or None if it is not listed."""
    return next(((bw, flops) for key, bw, flops in CARD_PEAKS if key in name), None)


@functools.lru_cache(maxsize=1)
def device_kind() -> str:
    """Name of card 0 (``torch.cuda.get_device_name``), or ``"cpu"``."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0)


@functools.lru_cache(maxsize=1)
def native_fp8_matmul() -> bool:
    """True when card 0 multiplies fp8 operands natively (sm_89 and newer)."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(0) >= (8, 9)


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    Without a card and without an explicit device this raises rather than
    quietly running on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def resolve_kv_dtype(kv_dtype: Any, device: Optional[Any] = None):
    """Map the engine-config ``kv_dtype`` field to a torch dtype.

    ``"auto"`` → e4m3 on a card with native fp8, bf16 elsewhere (the CPU).
    ``"fp8"``, ``"int8"`` and ``"bf16"`` name their dtypes; a torch dtype
    passes through.
    """
    if kv_dtype == "auto":
        on_card = device is not None and torch.device(device).type == "cuda"
        return (torch.float8_e4m3fn if on_card and native_fp8_matmul()
                else torch.bfloat16)
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "bf16":
        return torch.bfloat16
    if isinstance(kv_dtype, torch.dtype):
        return kv_dtype
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
