"""Plain tensor ops of the model: norms, rotary, attention, sampling."""
from .attention import attention, attention_ref, decode_attention
from .rmsnorm import rmsnorm, rmsnorm_residual
from .rotary import apply_rope, rope_cos_sin, rope_frequencies
from .sampling import filtered_logits, filtered_probs, greedy, sample

__all__ = ["attention", "attention_ref", "decode_attention", "rmsnorm", "rmsnorm_residual",
           "apply_rope", "rope_cos_sin", "rope_frequencies",
           "greedy", "sample", "filtered_logits", "filtered_probs"]
