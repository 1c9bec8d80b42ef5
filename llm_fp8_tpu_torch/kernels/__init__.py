"""Hand-written Hopper kernels (CUDA C++, ``csrc/``) with their plain
PyTorch versions. Importing this package builds nothing: a kernel's library
is built by ``nvcc`` at its first launch (``_build.py``)."""
from __future__ import annotations

from . import (decode_attention, flash_attention, flash_attention_bwd, paged_attention,
               quant_matmul, quantize, rmsnorm)

__all__ = ["KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts"]

#: Kernel name → wrapper; each wrapper counts its own launches.
KERNEL_WRAPPERS = {
    "quant_matmul": quant_matmul.quant_matmul,
    "decode_attention_arena": decode_attention.decode_attention_arena,
    "flash_attention": flash_attention.flash_attention,
    "flash_attention_f32": flash_attention.flash_fwd_f32,
    "paged_attention": paged_attention.paged_attention,
    "flash_attention_bwd_dkv": flash_attention_bwd.flash_bwd_dkv,
    "flash_attention_bwd_dq": flash_attention_bwd.flash_bwd_dq,
    "flash_attention_bwd_f32_dq": flash_attention_bwd.flash_bwd_f32_dq,
    "flash_attention_bwd_f32_dkv": flash_attention_bwd.flash_bwd_f32_dkv,
    "quantize_fused": quantize.quantize_fused,
    "flash_attention_fp8": flash_attention.flash_attention_fp8,
    "rmsnorm_residual_fused": rmsnorm.rmsnorm_residual_fused,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
