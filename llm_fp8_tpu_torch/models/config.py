"""Model configuration + the supported-model registry (a copy of
``llm_fp8_tpu/models/config.py``, which the port does not import).

Covers the reference's supported model list (``train_fp8.py:50-56``):
Llama-3.2-1B/3B, Llama-3.1-8B, Qwen2.5-1.5B/14B — one decoder architecture
(RMSNorm, GQA, RoPE, SwiGLU) parameterized by this dataclass. Qwen2.5 differs
from Llama only in QKV projection biases and RoPE theta; both map onto the
same forward function.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "MODEL_REGISTRY", "get_config", "SUPPORTED_MODELS"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 500000.0
    rope_scaling: Optional[dict] = None  # HF llama3-style dict, or None
    rms_eps: float = 1e-5
    qkv_bias: bool = False  # Qwen2.x uses biases on q/k/v projections
    qk_norm: bool = False  # Qwen3 applies per-head RMSNorm to q and k
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 131072
    # Baichuan (flash_attn/models/baichuan.py:116-144): 13B replaces RoPE
    # with ALiBi slopes; both sizes store QKV as one fused W_pack tensor.
    alibi: bool = False
    fused_wpack: bool = False
    # Mistral: sliding-window attention (the kernels' ``window_size`` lever,
    # reference ``flash_attn_interface.py`` window_size=(W-1, 0)); None =
    # full causal.
    sliding_window: Optional[int] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_dim(self) -> int:
        return self.q_dim + 2 * self.kv_dim

    def num_params(self) -> int:
        """Approximate parameter count (for MFU / memory estimates)."""
        d, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (
            d * self.qkv_dim  # qkv
            + self.q_dim * d  # out proj
            + 3 * d * i  # gate, up, down
            + 2 * d  # norms
        )
        embed = v * d * (1 if self.tie_word_embeddings else 2)
        return self.num_layers * per_layer + embed + d


_LLAMA32_SCALING = dict(
    rope_type="llama3",
    factor=32.0,
    low_freq_factor=1.0,
    high_freq_factor=4.0,
    original_max_position_embeddings=8192,
)
_LLAMA31_SCALING = dict(_LLAMA32_SCALING, factor=8.0)

MODEL_REGISTRY = {
    # HF ids mirror the reference's SUPPORTED_MODELS (train_fp8.py:50-56).
    "meta-llama/Llama-3.2-1B": ModelConfig(
        name="llama-3.2-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500000.0, rope_scaling=_LLAMA32_SCALING,
        tie_word_embeddings=True,
    ),
    "meta-llama/Llama-3.2-3B": ModelConfig(
        name="llama-3.2-3b", vocab_size=128256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, rope_scaling=_LLAMA32_SCALING,
        tie_word_embeddings=True,
    ),
    "meta-llama/Llama-3.1-8B": ModelConfig(
        name="llama-3.1-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, rope_scaling=_LLAMA31_SCALING,
    ),
    "Qwen/Qwen2.5-1.5B": ModelConfig(
        name="qwen2.5-1.5b", vocab_size=151936, hidden_size=1536,
        intermediate_size=8960, num_layers=28, num_heads=12, num_kv_heads=2,
        head_dim=128, rope_theta=1000000.0, rms_eps=1e-6, qkv_bias=True,
        tie_word_embeddings=True, max_position_embeddings=32768,
    ),
    "Qwen/Qwen2.5-14B": ModelConfig(
        name="qwen2.5-14b", vocab_size=152064, hidden_size=5120,
        intermediate_size=13824, num_layers=48, num_heads=40, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, rms_eps=1e-5, qkv_bias=True,
        max_position_embeddings=131072,
    ),
    # Qwen3 (the reference's te_qwen.py imports Qwen3 classes first,
    # te_qwen.py:24-44): per-head QK-norm, no qkv bias.
    "Qwen/Qwen3-8B": ModelConfig(
        name="qwen3-8b", vocab_size=151936, hidden_size=4096,
        intermediate_size=12288, num_layers=36, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, rms_eps=1e-6, qk_norm=True,
        max_position_embeddings=40960,
    ),
    "debug-qwen3": ModelConfig(
        name="debug-qwen3", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, rope_theta=1000000.0, rms_eps=1e-6, qk_norm=True,
        max_position_embeddings=2048,
    ),
    # Precision-study config: the exact Llama-3.2-1B architecture with a
    # 32768-entry vocab matching the locally-trained BPE tokenizer
    # (scripts/build_corpus.py) — 1.04B params. The air-gapped stand-in for
    # the reference protocol's pretrained-checkpoint run
    # (train_fp8.py:316-356); everything but the embedding table is
    # dimension-identical to llama-3.2-1b.
    "llama-1b-32k": ModelConfig(
        name="llama-1b-32k", vocab_size=32768, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32, num_kv_heads=8,
        head_dim=64, rope_theta=500000.0, rope_scaling=_LLAMA32_SCALING,
        tie_word_embeddings=True,
    ),
    # Draft-scale sibling of llama-1b-32k (~8x fewer params, same vocab):
    # the trained (target, draft) pair for measuring speculative decoding
    # with real acceptance rates, mirroring the reference's
    # decode_speculative protocol (generation.py:269-565) which pairs a
    # big target with a small same-tokenizer draft.
    "llama-150m-32k": ModelConfig(
        name="llama-150m-32k", vocab_size=32768, hidden_size=1024,
        intermediate_size=4096, num_layers=8, num_heads=16, num_kv_heads=4,
        head_dim=64, rope_theta=500000.0, rope_scaling=_LLAMA32_SCALING,
        tie_word_embeddings=True,
    ),
    # Baichuan (flash_attn/models/baichuan.py): Llama block with fused
    # W_pack QKV; 7B uses RoPE, 13B uses ALiBi (inferred from hidden size in
    # the reference, baichuan.py:116-121 — here declared explicitly).
    "baichuan-7b": ModelConfig(
        name="baichuan-7b", vocab_size=64000, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_heads=32,
        num_kv_heads=32, head_dim=128, rope_theta=10000.0, rms_eps=1e-6,
        fused_wpack=True, max_position_embeddings=4096,
    ),
    "baichuan-13b": ModelConfig(
        name="baichuan-13b", vocab_size=64000, hidden_size=5120,
        intermediate_size=13696, num_layers=40, num_heads=40,
        num_kv_heads=40, head_dim=128, rms_eps=1e-6,
        alibi=True, fused_wpack=True, max_position_embeddings=4096,
    ),
    "debug-baichuan": ModelConfig(
        name="debug-baichuan", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=4,
        head_dim=32, rms_eps=1e-6, alibi=True, fused_wpack=True,
        max_position_embeddings=2048,
    ),
    # Small debug configs (the reference's debug presets train 100 samples on
    # tiny batches, run_multigpu.sh:104-126; we go further: tiny *models*).
    "debug-tiny": ModelConfig(
        name="debug-tiny", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, rope_theta=10000.0, max_position_embeddings=2048,
    ),
    "debug-small": ModelConfig(
        name="debug-small", vocab_size=2048, hidden_size=256,
        intermediate_size=1024, num_layers=4, num_heads=8, num_kv_heads=4,
        head_dim=64, rope_theta=500000.0, tie_word_embeddings=True,
        max_position_embeddings=4096,
    ),
}

MODEL_REGISTRY.update({
    # Mistral-7B-v0.1 (HF config.json): Llama skeleton + 4096-token sliding
    # window — exercises the kernels' window lever at the model level.
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=10000.0, rms_eps=1e-5,
        max_position_embeddings=32768, sliding_window=4096,
    ),
    "debug-mistral": ModelConfig(
        name="debug-mistral", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, rope_theta=10000.0, rms_eps=1e-5,
        max_position_embeddings=2048, sliding_window=6,
    ),
})

# Short aliases
MODEL_REGISTRY.update({
    "llama-3.2-1b": MODEL_REGISTRY["meta-llama/Llama-3.2-1B"],
    "llama-3.2-3b": MODEL_REGISTRY["meta-llama/Llama-3.2-3B"],
    "llama-3.1-8b": MODEL_REGISTRY["meta-llama/Llama-3.1-8B"],
    "qwen2.5-1.5b": MODEL_REGISTRY["Qwen/Qwen2.5-1.5B"],
    "qwen2.5-14b": MODEL_REGISTRY["Qwen/Qwen2.5-14B"],
    "qwen3-8b": MODEL_REGISTRY["Qwen/Qwen3-8B"],
})

SUPPORTED_MODELS = sorted({c.name for c in MODEL_REGISTRY.values()})


def get_config(name: str) -> ModelConfig:
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    raise ValueError(
        f"unsupported model {name!r}. Supported: {sorted(MODEL_REGISTRY)}"
    )
