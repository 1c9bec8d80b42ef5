"""PyTorch/CUDA port of ``llm_fp8_tpu`` for NVIDIA Hopper (sm_90a).

Module names mirror the JAX package so each counterpart is easy to find.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA tensor launches the hand-written kernels under ``csrc/``, a CPU tensor
takes each kernel's plain PyTorch version.
"""
