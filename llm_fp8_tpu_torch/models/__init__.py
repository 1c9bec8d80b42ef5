"""Model configurations, the Llama-family decoder, the GPT-2, NeoX, Gemma-2,
MoE and MLA families, the registry that resolves a name across them, and the
BERT and ViT encoders (no registry entry, engine or trainer, as in the JAX
package)."""
from .bert import BERT_REGISTRY, BertConfig, bert_forward, bert_mlm_logits, init_bert_params
from .config import MODEL_REGISTRY, SUPPORTED_MODELS, ModelConfig, get_config
from .gemma import GEMMA_REGISTRY, GemmaConfig, gemma_forward, init_gemma_params
from .gpt2 import GPT2_REGISTRY, GPT2Config, gpt2_forward, init_gpt2_params
from .llama import (KVCache, forward, forward_decode_arena, forward_paged, init_kv_cache,
                    init_params, quantize_params)
from .mla import MLA_REGISTRY, MLAConfig, init_mla_params, mla_forward, quantize_mla_params
from .moe import MOE_REGISTRY, MoEConfig, init_moe_params, moe_forward, quantize_moe_params
from .neox import NEOX_REGISTRY, NeoXConfig, init_neox_params, neox_forward
from .registry import (ZooEntry, load_zoo_checkpoint, quantize_zoo_params, resolve_model,
                       zoo_model_names)
from .vit import VIT_REGISTRY, ViTConfig, init_vit_params, vit_forward

__all__ = ["ModelConfig", "MODEL_REGISTRY", "SUPPORTED_MODELS", "get_config",
           "init_params", "quantize_params", "KVCache", "init_kv_cache", "forward",
           "forward_decode_arena", "forward_paged",
           "GPT2Config", "GPT2_REGISTRY", "init_gpt2_params", "gpt2_forward",
           "NeoXConfig", "NEOX_REGISTRY", "init_neox_params", "neox_forward",
           "GemmaConfig", "GEMMA_REGISTRY", "init_gemma_params", "gemma_forward",
           "MoEConfig", "MOE_REGISTRY", "init_moe_params", "moe_forward", "quantize_moe_params",
           "MLAConfig", "MLA_REGISTRY", "init_mla_params", "mla_forward", "quantize_mla_params",
           "ZooEntry", "resolve_model", "zoo_model_names", "quantize_zoo_params",
           "load_zoo_checkpoint", "BertConfig", "BERT_REGISTRY", "init_bert_params",
           "bert_forward", "bert_mlm_logits", "ViTConfig", "VIT_REGISTRY", "init_vit_params",
           "vit_forward"]
