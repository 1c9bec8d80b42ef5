"""Plain tensor ops of the models: norms, rotary, attention, split-KV attention,
variable-length packing, sampling."""
from .attention import (alibi_slopes_list, attention, attention_ref, decode_attention,
                        default_alibi_slopes)
from .layernorm import layernorm
from .rmsnorm import rmsnorm, rmsnorm_residual
from .rotary import apply_rope, rope_cos_sin, rope_frequencies
from .sampling import filtered_logits, filtered_probs, greedy, sample
from .split_kv import auto_num_splits, combine_partials, split_kv_attention
from .varlen import cu_seqlens, pack_sequences, pad_input, unpad_input

__all__ = ["attention", "attention_ref", "decode_attention", "alibi_slopes_list",
           "default_alibi_slopes", "layernorm", "rmsnorm", "rmsnorm_residual",
           "apply_rope", "rope_cos_sin", "rope_frequencies",
           "greedy", "sample", "filtered_logits", "filtered_probs",
           "auto_num_splits", "combine_partials", "split_kv_attention",
           "unpad_input", "pad_input", "pack_sequences", "cu_seqlens"]
