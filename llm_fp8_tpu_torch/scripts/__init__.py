"""Measurement scripts of the port, run as ``python -m llm_fp8_tpu_torch.scripts.<name>``."""
