"""Delayed scaling as explicit state (counterpart of ``llm_fp8_tpu/quant/delayed.py``).

A :class:`ScaleState` holds a rolling amax history and the scale to use this
step, derived from the history before the step ran. The trainer observes
each step's amaxes and replaces the state; nothing is updated in place.
Every function works on stacked states too (``history [..., H]``,
``scale [...]``), as the JAX package vmaps them over layers.
"""
from __future__ import annotations

import dataclasses

import torch

from .formats import Format
from .qtensor import compute_scale

__all__ = ["ScaleState", "init_scale_state", "observe_amax", "current_scale"]


@dataclasses.dataclass(frozen=True)
class ScaleState:
    """``history[..., 0]`` is the most recent observation; ``scale`` is the
    scale to use this step."""

    history: torch.Tensor  # [..., amax_history_len] float32
    scale: torch.Tensor  # [...] float32


def init_scale_state(history_len: int = 16, *, shape=(), device="cpu") -> ScaleState:
    return ScaleState(
        history=torch.zeros((*shape, history_len), dtype=torch.float32, device=device),
        scale=torch.ones(shape, dtype=torch.float32, device=device),
    )


def observe_amax(state: ScaleState, amax: torch.Tensor, fmt: Format, *,
                 amax_compute: str = "max", margin: int = 0) -> ScaleState:
    """Record this step's amax (roll, then write slot 0) and derive the next
    step's scale from the ``max`` of the history or its ``most_recent`` entry."""
    history = torch.roll(state.history, 1, dims=-1)
    history[..., 0] = torch.as_tensor(amax, dtype=torch.float32, device=history.device)
    if amax_compute == "max":
        eff = history.amax(dim=-1)
    elif amax_compute == "most_recent":
        eff = history[..., 0]
    else:
        raise ValueError(f"unknown amax_compute {amax_compute!r}")
    return ScaleState(history=history, scale=compute_scale(eff, fmt, margin))


def current_scale(x: torch.Tensor, fmt: Format, margin: int = 0) -> torch.Tensor:
    """Just-in-time scaling: the scale from this tensor's own amax."""
    return compute_scale(x.float().abs().amax(), fmt, margin)
