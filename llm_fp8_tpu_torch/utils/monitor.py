"""Device monitoring (counterpart of ``llm_fp8_tpu/utils/monitor.py``): the
card's memory counters from ``torch.cuda.memory_stats``, a step timer, phase
snapshots and the closed-form training-memory estimate."""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

__all__ = ["device_memory_stats", "MemoryProfiler", "StepTimer", "estimate_memory_gb"]

_GB = 1024 ** 3


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """This process's device memory in GB: in use, peak and the card's total
    (``torch.cuda.memory_stats``: the caching allocator's tensors, not the
    cache it keeps); zeros with ``source`` "cpu" without a card."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return {"in_use_gb": 0.0, "peak_gb": 0.0, "limit_gb": 0.0, "source": "cpu"}
    stats = torch.cuda.memory_stats(device)
    return {"in_use_gb": stats.get("allocated_bytes.all.current", 0) / _GB,
            "peak_gb": stats.get("allocated_bytes.all.peak", 0) / _GB,
            "limit_gb": torch.cuda.get_device_properties(device).total_memory / _GB,
            "source": "torch.cuda.memory_stats"}


class MemoryProfiler:
    """Phase-tagged :func:`device_memory_stats` snapshots."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = device
        self.snapshots: Dict[str, Dict[str, float]] = {}

    def snapshot(self, phase: str) -> Dict[str, float]:
        s = device_memory_stats(self.device)
        self.snapshots[phase] = s
        return s

    def report(self) -> Dict[str, Dict[str, float]]:
        return dict(self.snapshots)


class StepTimer:
    """Host wall time and token throughput since the last reset (the step
    functions read their results on the host, so the device has caught up)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._tokens = 0

    def step(self, tokens: int = 0) -> None:
        self._steps += 1
        self._tokens += tokens

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {"steps_per_s": self._steps / dt, "tokens_per_s": self._tokens / dt,
                "elapsed_s": dt}


def estimate_memory_gb(num_params: int, *, n_devices: int = 1, shard_params: bool = False,
                       fp8_weights: bool = False, optimizer: str = "adamw",
                       batch_tokens: int = 0, hidden: int = 0, layers: int = 0) -> float:
    """Closed-form per-device training memory (JAX's and the reference's
    model): params (bf16 or fp8) + grads (bf16) + AdamW moments (2 x
    float32), divided by the device count when sharded, plus ~34 bytes a
    token, hidden unit and layer of activations without remat."""
    param_b = num_params * (1 if fp8_weights else 2)
    state = param_b + num_params * 2 + (num_params * 8 if optimizer == "adamw" else 0)
    if shard_params:
        state /= max(n_devices, 1)
    act_b = 0
    if batch_tokens and hidden and layers:
        act_b = 34 * batch_tokens * hidden * layers / max(n_devices, 1)
    return (state + act_b) / _GB
