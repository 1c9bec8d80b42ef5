"""Metric sinks (counterpart of ``llm_fp8_tpu/utils/metrics.py``): a JSONL
file always, TensorBoard where ``torch.utils.tensorboard`` imports. The
Weights & Biases sink is refused: the port runs without a network."""
from __future__ import annotations

import json
import os
import time
from typing import Dict

__all__ = ["MetricLogger"]


class MetricLogger:
    """``log(metrics, step, prefix)`` appends one JSON line
    ``{"step", "time", "<prefix>/<key>": value}`` to ``log_dir/metrics.jsonl``
    (numbers only) and writes the same scalars to TensorBoard when
    available; ``log_summary`` appends ``{"summary": ...}``."""

    def __init__(self, log_dir: str, *, use_tensorboard: bool = True, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError("use_wandb: the port logs without a network "
                                      "(JSONL and TensorBoard)")
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:  # noqa: BLE001 - tensorboard is optional
                self._tb = None

    def log(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        tagged = {(f"{prefix}/{k}" if prefix else k): float(v)
                  for k, v in metrics.items() if isinstance(v, (int, float))}
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **tagged}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in tagged.items():
                self._tb.add_scalar(k, v, step)

    def log_summary(self, summary: Dict) -> None:
        self._jsonl.write(json.dumps({"summary": summary}, default=str) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
