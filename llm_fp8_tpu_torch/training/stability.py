"""Numerical-stability analytics for FP8 training runs (a copy of
``llm_fp8_tpu/training/stability.py``, which is pure numpy and scipy: the port
keeps its own so that it imports nothing of the JAX package).

Port of the reference's ``StabilityExperiment`` (``train_fp8.py:408-654``).
Tracked series (10k-cap deques like the reference): loss, grad-norm, lr, and
activation mean/std of the final-norm hidden states, which the trainer
computes each step. Report statistics: mean/median/std/CV/IQR/max-deviation/
range, exponential-fit convergence rate, sign-flip oscillation index,
early-vs-late variance stability ratio, and a normality test on loss deltas.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, Optional

import numpy as np

__all__ = ["StabilityTracker", "series_stats"]

_CAP = 10_000


def series_stats(x: np.ndarray) -> Dict[str, float]:
    """Descriptive statistics for one metric series."""
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x)]
    if x.size == 0:
        return {}
    mean = float(np.mean(x))
    std = float(np.std(x))
    q1, med, q3 = (float(v) for v in np.percentile(x, [25, 50, 75]))
    return {
        "mean": mean,
        "median": med,
        "std": std,
        "variance": std ** 2,
        "cv": std / abs(mean) if mean else float("inf"),
        "iqr": q3 - q1,
        "max_deviation": float(np.max(np.abs(x - mean))),
        "range": float(np.max(x) - np.min(x)),
        "min": float(np.min(x)),
        "max": float(np.max(x)),
    }


def _convergence_rate(loss: np.ndarray) -> Optional[float]:
    """Exponential-decay fit ``loss ≈ a·exp(-r·t) + c``; returns r.

    Linearized fit on log(loss - min + eps), the reference's approach for a
    cheap convergence-speed scalar.
    """
    if loss.size < 10:
        return None
    t = np.arange(loss.size, dtype=np.float64)
    shifted = loss - loss.min() + 1e-8
    try:
        slope, _ = np.polyfit(t, np.log(shifted), 1)
    except Exception:
        return None
    return float(-slope)


def _oscillation_index(x: np.ndarray) -> float:
    """Fraction of steps where the first difference changes sign."""
    if x.size < 3:
        return 0.0
    d = np.diff(x)
    signs = np.sign(d)
    flips = np.sum(signs[1:] * signs[:-1] < 0)
    return float(flips) / max(d.size - 1, 1)


def _stability_ratio(x: np.ndarray) -> Optional[float]:
    """Late-phase variance / early-phase variance (<1 = stabilizing)."""
    if x.size < 20:
        return None
    k = x.size // 4
    early, late = np.var(x[:k]), np.var(x[-k:])
    return float(late / early) if early > 0 else None


def _normality_pvalue(x: np.ndarray) -> Optional[float]:
    """Normality test on loss deltas (noise should be ~gaussian when stable)."""
    if x.size < 20:
        return None
    try:
        from scipy import stats

        _, p = stats.normaltest(np.diff(x))
        return float(p)
    except Exception:
        return None


@dataclasses.dataclass
class StabilityTracker:
    """Per-step metric tracking + end-of-run stability report."""

    precision_name: str = "bf16"

    def __post_init__(self):
        self.loss: Deque[float] = collections.deque(maxlen=_CAP)
        self.grad_norm: Deque[float] = collections.deque(maxlen=_CAP)
        self.lr: Deque[float] = collections.deque(maxlen=_CAP)
        self.activation_mean: Deque[float] = collections.deque(maxlen=_CAP)
        self.activation_std: Deque[float] = collections.deque(maxlen=_CAP)
        self.non_finite_steps = 0
        self.steps = 0

    def track_step(
        self,
        loss: float,
        grad_norm: Optional[float] = None,
        lr: Optional[float] = None,
        activation_mean: Optional[float] = None,
        activation_std: Optional[float] = None,
    ) -> Dict[str, float]:
        """Record one step; returns instantaneous metrics for logging.

        ``activation_mean``/``activation_std`` are the two scalars the
        reference computes over the last hidden states each step
        (``train_fp8.py:459-461``); pass NaN (or omit) when the step didn't
        produce them — non-finite values are dropped from the series.
        """
        self.steps += 1
        if not math.isfinite(loss):
            self.non_finite_steps += 1
        else:
            self.loss.append(loss)
        if grad_norm is not None and math.isfinite(grad_norm):
            self.grad_norm.append(grad_norm)
        if lr is not None:
            self.lr.append(lr)
        if activation_mean is not None and math.isfinite(activation_mean):
            self.activation_mean.append(activation_mean)
        if activation_std is not None and math.isfinite(activation_std):
            self.activation_std.append(activation_std)
        out = {"loss": loss}
        if len(self.loss) >= 2:
            out["loss_delta"] = self.loss[-1] - self.loss[-2]
        if grad_norm is not None:
            out["grad_norm"] = grad_norm
        if activation_mean is not None and math.isfinite(activation_mean):
            out["activation_mean"] = activation_mean
        if activation_std is not None and math.isfinite(activation_std):
            out["activation_std"] = activation_std
        return out

    def report(self) -> Dict[str, object]:
        """End-of-run statistical report (wandb.summary payload in the ref)."""
        loss = np.asarray(self.loss, np.float64)
        rep: Dict[str, object] = {
            "precision": self.precision_name,
            "steps": self.steps,
            "non_finite_steps": self.non_finite_steps,
            "loss_stats": series_stats(loss),
            "grad_norm_stats": series_stats(np.asarray(self.grad_norm)),
            "activation_mean_stats": series_stats(
                np.asarray(self.activation_mean)),
            "activation_std_stats": series_stats(
                np.asarray(self.activation_std)),
        }
        if loss.size:
            rep["convergence_rate"] = _convergence_rate(loss)
            rep["oscillation_index"] = _oscillation_index(loss)
            rep["variance_stability_ratio"] = _stability_ratio(loss)
            rep["loss_delta_normality_p"] = _normality_pvalue(loss)
        return rep
