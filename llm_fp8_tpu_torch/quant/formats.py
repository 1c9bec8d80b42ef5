"""Low-precision storage formats (counterpart of ``llm_fp8_tpu/quant/formats.py``).

A format is plain data: the torch storage dtype and its largest finite
magnitude, which the scale computation divides by.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Format", "E4M3", "E5M2", "INT8", "INT4", "format_by_name"]


@dataclasses.dataclass(frozen=True)
class Format:
    name: str
    dtype: torch.dtype
    max: float

    def __repr__(self) -> str:
        return f"Format({self.name})"

    @property
    def is_integer(self) -> bool:
        return not self.dtype.is_floating_point


E4M3 = Format("e4m3", torch.float8_e4m3fn, float(torch.finfo(torch.float8_e4m3fn).max))
E5M2 = Format("e5m2", torch.float8_e5m2, float(torch.finfo(torch.float8_e5m2).max))
INT8 = Format("int8", torch.int8, 127.0)
#: Symmetric int4, nibble-packed two per int8 byte (split-half layout).
INT4 = Format("int4", torch.int8, 7.0)

_BY_NAME = {f.name: f for f in (E4M3, E5M2, INT8, INT4)}


def format_by_name(name: str) -> Format:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(f"unknown fp8 format {name!r}; known: {sorted(_BY_NAME)}")
