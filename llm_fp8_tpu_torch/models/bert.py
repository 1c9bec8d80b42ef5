"""BERT-class encoder: bidirectional attention, post-LN blocks, the tanh
pooler and the tied MLM head (counterpart of ``llm_fp8_tpu/models/bert.py``;
the registry is a copy, which the port keeps since it imports nothing of the
JAX package).

Parameters keep the JAX package's stacked layout (``[num_layers, ...]``
leaves, fused ``w_qkv = [q|k|v]`` columns, ``[in, out]`` weights; weights are
tensors or :class:`~..quant.QTensor`, whose products take ``qdot``'s routes).
Padding is masked by ``lens`` (right-padded rows): attention is non-causal
with ``kv_lens=lens``, so no valid position attends to padding, and the rows
past ``lens`` are zeroed before the pooler, as in the JAX forward. The
forward computes in float32 by default (``compute_dtype``): on the card its
attention is K3's float32 instance, non-causal; the GELU is the exact (erf)
one, in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.layernorm import layernorm
from ..utils.backend import resolve_device
from .llama import _dot, unstack_layers
from .zoo import lm_logits, stacker, state_getter

__all__ = ["BertConfig", "BERT_REGISTRY", "init_bert_params", "bert_forward",
           "bert_mlm_logits", "pack_bert_state_dict"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    name: str
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_REGISTRY = {
    "bert-base-uncased": BertConfig(name="bert-base-uncased"),
    "bert-large-uncased": BertConfig(name="bert-large-uncased",
                                     hidden_size=1024, intermediate_size=4096,
                                     num_layers=24, num_heads=16),
    "debug-bert": BertConfig(name="debug-bert", vocab_size=512,
                             hidden_size=128, intermediate_size=512,
                             num_layers=2, num_heads=4,
                             max_position_embeddings=128),
}


def init_bert_params(cfg: BertConfig, generator: Optional[torch.Generator] = None, *,
                     dtype=torch.float32, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02), drawn on ``device`` from ``generator``
    (a new one seeded with ``seed`` when none is given); norms 1, biases 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def w(*shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * std).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wte": w(cfg.vocab_size, D),
        "wpe": w(cfg.max_position_embeddings, D),
        "wtype": w(cfg.type_vocab_size, D),
        "emb_ln_w": full(1.0, D), "emb_ln_b": full(0.0, D),
        "layers": {
            "w_qkv": w(L, D, 3 * D),
            "b_qkv": full(0.0, L, 3 * D),
            "w_out": w(L, D, D),
            "b_out": full(0.0, L, D),
            "ln1_w": full(1.0, L, D), "ln1_b": full(0.0, L, D),
            "w_fc": w(L, D, I),
            "b_fc": full(0.0, L, I),
            "w_proj": w(L, I, D),
            "b_proj": full(0.0, L, D),
            "ln2_w": full(1.0, L, D), "ln2_b": full(0.0, L, D),
        },
        "pool_w": w(D, D), "pool_b": full(0.0, D),
        "mlm_w": w(D, D), "mlm_b": full(0.0, D),
        "mlm_ln_w": full(1.0, D), "mlm_ln_b": full(0.0, D),
        "mlm_bias": full(0.0, cfg.vocab_size),
    }


def pack_bert_state_dict(sd, cfg: BertConfig, dtype=torch.float32, device=None):
    """HF ``BertForMaskedLM`` (or ``BertModel`` with ``bert.``-prefixed keys)
    state dict → stacked params. The separate q/k/v Linears ``[out, in]``
    concatenate transposed into one ``[D, 3D]`` block; a missing pooler or
    MLM head gets JAX's fallbacks (zero weights and biases, unit norm)."""
    g = state_getter(sd, dtype, device)
    D, L = cfg.hidden_size, cfg.num_layers
    p = "bert.encoder.layer.{}."
    stack = stacker(g, L)
    wte = g("bert.embeddings.word_embeddings.weight")

    def qkv(i, kind):
        parts = [g(p.format(i) + f"attention.self.{n}.{kind}")
                 for n in ("query", "key", "value")]
        return torch.cat([t.t() for t in parts], dim=1) if kind == "weight" else torch.cat(parts)

    def opt(name, fallback, tr=False):
        if name not in sd:
            return fallback
        return g(name).t() if tr else g(name)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=wte.device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=wte.device)

    return {
        "wte": wte,
        "wpe": g("bert.embeddings.position_embeddings.weight"),
        "wtype": g("bert.embeddings.token_type_embeddings.weight"),
        "emb_ln_w": g("bert.embeddings.LayerNorm.weight"),
        "emb_ln_b": g("bert.embeddings.LayerNorm.bias"),
        "layers": {
            "w_qkv": torch.stack([qkv(i, "weight") for i in range(L)]),
            "b_qkv": torch.stack([qkv(i, "bias") for i in range(L)]),
            "w_out": stack(p + "attention.output.dense.weight", tr=True),
            "b_out": stack(p + "attention.output.dense.bias"),
            "ln1_w": stack(p + "attention.output.LayerNorm.weight"),
            "ln1_b": stack(p + "attention.output.LayerNorm.bias"),
            "w_fc": stack(p + "intermediate.dense.weight", tr=True),
            "b_fc": stack(p + "intermediate.dense.bias"),
            "w_proj": stack(p + "output.dense.weight", tr=True),
            "b_proj": stack(p + "output.dense.bias"),
            "ln2_w": stack(p + "output.LayerNorm.weight"),
            "ln2_b": stack(p + "output.LayerNorm.bias"),
        },
        "pool_w": opt("bert.pooler.dense.weight", zeros(D, D), tr=True),
        "pool_b": opt("bert.pooler.dense.bias", zeros(D)),
        "mlm_w": opt("cls.predictions.transform.dense.weight", zeros(D, D), tr=True),
        "mlm_b": opt("cls.predictions.transform.dense.bias", zeros(D)),
        "mlm_ln_w": opt("cls.predictions.transform.LayerNorm.weight", ones(D)),
        "mlm_ln_b": opt("cls.predictions.transform.LayerNorm.bias", zeros(D)),
        "mlm_bias": opt("cls.predictions.bias", zeros(cfg.vocab_size)),
    }


def encoder_attn_impl(attn_impl: str) -> None:
    """The encoders' ``attn_impl`` as the port's zoo forwards take it:
    ``"auto"`` only (one attention route per device: K3 on the card, the
    golden ``attention_ref`` on the CPU)."""
    if attn_impl != "auto":
        raise NotImplementedError(f"attn_impl {attn_impl!r}: the port has one attention "
                                  "route per device ('auto')")


def gelu_f32(h: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU in float32, back in h's dtype."""
    return F.gelu(h.float()).to(h.dtype)


def bert_forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: BertConfig, *,
                 lens: Optional[torch.Tensor] = None,
                 token_type_ids: Optional[torch.Tensor] = None, attn_impl: str = "auto",
                 compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``tokens [B, S]`` → ``(sequence_output [B, S, D], pooled [B, D])``.
    ``lens [B]`` masks right padding both ways (queries past a row's length
    give rows that are zeroed before return)."""
    encoder_attn_impl(attn_impl)
    dev = params["wte"].device
    tokens = tokens.to(dev).long()
    B, S = tokens.shape
    D, H, Dh = cfg.hidden_size, cfg.num_heads, cfg.head_dim
    pos = torch.arange(S, device=dev)
    ttype = (token_type_ids.to(dev).long() if token_type_ids is not None
             else torch.zeros_like(tokens))
    if lens is not None:
        lens = lens.to(device=dev, dtype=torch.int32)
    x = (params["wte"][tokens] + params["wpe"][pos][None]
         + params["wtype"][ttype]).to(compute_dtype)
    x = layernorm(x, params["emb_ln_w"], params["emb_ln_b"], cfg.ln_eps)
    for lp in unstack_layers(params["layers"]):
        qkv = _dot(x, lp["w_qkv"]) + lp["b_qkv"].to(x.dtype)
        q, k, v = (t.reshape(B, S, H, Dh) for t in torch.split(qkv, D, dim=-1))
        a = attention(q, k, v, causal=False, kv_lens=lens)
        h = _dot(a.reshape(B, S, D), lp["w_out"]) + lp["b_out"].to(x.dtype)
        x = layernorm(x + h, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)  # post-LN
        h = gelu_f32(_dot(x, lp["w_fc"]) + lp["b_fc"].to(x.dtype))
        h = _dot(h, lp["w_proj"]) + lp["b_proj"].to(x.dtype)
        x = layernorm(x + h, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
    if lens is not None:
        x = torch.where(pos[None, :, None] < lens[:, None, None].long(), x,
                        torch.zeros_like(x))
    pooled = torch.tanh(_dot(x[:, 0], params["pool_w"]) + params["pool_b"].to(x.dtype))
    return x, pooled


def bert_mlm_logits(params: Dict[str, Any], sequence_output: torch.Tensor,
                    cfg: BertConfig) -> torch.Tensor:
    """The MLM head: dense, GELU and LayerNorm, then the tied decoder (a
    float32-output product with the word embeddings) plus the output bias.
    ``[B, S, D]`` → float32 ``[B, S, V]``."""
    h = _dot(sequence_output, params["mlm_w"]) + params["mlm_b"].to(sequence_output.dtype)
    h = layernorm(gelu_f32(h), params["mlm_ln_w"], params["mlm_ln_b"], cfg.ln_eps)
    return lm_logits(params, h) + params["mlm_bias"].float()
