"""Model configurations and the Llama-family decoder."""
from .config import MODEL_REGISTRY, SUPPORTED_MODELS, ModelConfig, get_config
from .llama import (KVCache, forward, forward_decode_arena, forward_paged, init_kv_cache,
                    init_params, quantize_params)

__all__ = ["ModelConfig", "MODEL_REGISTRY", "SUPPORTED_MODELS", "get_config",
           "init_params", "quantize_params", "KVCache", "init_kv_cache", "forward",
           "forward_decode_arena", "forward_paged"]
