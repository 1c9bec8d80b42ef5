"""Training: the FP8 fine-tuning harness (trainer, losses, delayed-scaling
state, data and stability analytics, train-state checkpoints and the HF
export)."""
from .checkpoint import CheckpointManager, export_hf
from .data import (CHAT_TEMPLATE, DataConfig, DataManager, ResumableBatches, make_batches,
                   synthetic_examples)
from .losses import IGNORE_INDEX, causal_lm_loss, chunked_causal_lm_loss
from .quant_state import forward_scales, init_train_quant_state, make_sinks, update_quant_state
from .stability import StabilityTracker, series_stats
from .trainer import TrainConfig, Trainer, TrainState, make_optimizer

__all__ = [
    "TrainConfig", "TrainState", "Trainer", "make_optimizer", "CheckpointManager", "export_hf",
    "causal_lm_loss", "chunked_causal_lm_loss", "IGNORE_INDEX",
    "DataConfig", "DataManager", "make_batches", "CHAT_TEMPLATE",
    "ResumableBatches", "synthetic_examples",
    "StabilityTracker", "series_stats",
    "init_train_quant_state", "forward_scales", "make_sinks", "update_quant_state",
]
