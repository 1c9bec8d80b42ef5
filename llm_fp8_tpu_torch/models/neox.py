"""Parallel-residual decoder family: GPT-NeoX / Pythia, Falcon and GPT-J
(counterpart of ``llm_fp8_tpu/models/neox.py``; the registry is a copy).

One block whose config covers the parallel residual (``x + attn(ln1(x)) +
mlp(ln2(x))``) or the sequential pre-LN block; Falcon-7B's and GPT-J's one
LayerNorm shared by both branches (``tied_norm``); partial rotary
(``rotary_pct`` of each head's dims) in the rotate-half (NeoX, Falcon) or
the interleaved (GPT-J) pairing; multi-query KV (Falcon); biasless linears
(Falcon everywhere, GPT-J in attention) and GPT-J's biased lm_head. Stacked
``[num_layers, ...]`` parameters as in the JAX package; weights are tensors
or :class:`~..quant.QTensor`.

The forward computes in float32 by default, as the JAX one does; with a
cache it runs the Llama family's cache step, so the serving engine drives
it through ``forward_fn``. The rotary inverse frequencies are built once
per (rotary dims, base, device), so a decode step reads no host tensor and
can be captured as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.layernorm import layernorm
from ..ops.rotary import apply_rope, rope_cos_sin, rope_frequencies
from ..utils.backend import resolve_device
from .llama import _dot
from .zoo import lm_logits, run_layers, stacker, state_getter, training_knobs

__all__ = ["NeoXConfig", "NEOX_REGISTRY", "init_neox_params", "neox_forward",
           "pack_neox_state_dict", "pack_falcon_state_dict", "pack_gptj_state_dict"]


@dataclasses.dataclass(frozen=True)
class NeoXConfig:
    name: str
    vocab_size: int = 50432
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = -1  # -1 = num_heads; 1 = Falcon-style multi-query
    rotary_pct: float = 0.25  # fraction of head_dim rotated (Falcon: 1.0)
    rotary_base: float = 10000.0
    parallel_residual: bool = True
    tied_norm: bool = False  # Falcon-7B / GPT-J: one LN feeds both branches
    use_bias: bool = True  # Falcon: False
    # GPT-J: biasless attention projections but biased MLP. -1 = follow
    # use_bias; 0/1 override for the attention projections only.
    attn_bias: int = -1
    # GPT-J rotates interleaved (even, odd) pairs instead of rotate-half.
    rope_interleaved: bool = False
    lm_head_bias: bool = False  # GPT-J's lm_head has a bias
    gelu_approximate: bool = False  # GPT-J: gelu_new (tanh approximation)
    ln_eps: float = 1e-5
    tie_word_embeddings: bool = False

    @property
    def attn_has_bias(self) -> bool:
        return self.use_bias if self.attn_bias < 0 else bool(self.attn_bias)

    def __post_init__(self):
        if self.num_kv_heads < 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def rotary_dim(self) -> int:
        # HF GPTNeoX truncates (int), e.g. 0.25 * 64 = 16.
        return int(self.head_dim * self.rotary_pct)


NEOX_REGISTRY = {
    # Pythia suite dims (EleutherAI/pythia-*; rotary_pct=0.25).
    "pythia-160m": NeoXConfig(name="pythia-160m", hidden_size=768,
                              num_layers=12, num_heads=12),
    "pythia-410m": NeoXConfig(name="pythia-410m", hidden_size=1024,
                              intermediate_size=4096, num_layers=24,
                              num_heads=16),
    "pythia-1.4b": NeoXConfig(name="pythia-1.4b", hidden_size=2048,
                              intermediate_size=8192, num_layers=24,
                              num_heads=16),
    # Falcon-7B: MQA, full rotary, tied parallel norm, no biases.
    "falcon-7b": NeoXConfig(name="falcon-7b", vocab_size=65024,
                            hidden_size=4544, intermediate_size=18176,
                            num_layers=32, num_heads=71, num_kv_heads=1,
                            rotary_pct=1.0, parallel_residual=True,
                            tied_norm=True, use_bias=False,
                            tie_word_embeddings=True),
    "debug-neox": NeoXConfig(name="debug-neox", vocab_size=512,
                             hidden_size=128, intermediate_size=512,
                             num_layers=2, num_heads=4),
    "debug-falcon": NeoXConfig(name="debug-falcon", vocab_size=512,
                               hidden_size=128, intermediate_size=512,
                               num_layers=2, num_heads=4, num_kv_heads=1,
                               rotary_pct=1.0, tied_norm=True,
                               use_bias=False, tie_word_embeddings=True),
    "debug-neox-seq": NeoXConfig(name="debug-neox-seq", vocab_size=512,
                                 hidden_size=128, intermediate_size=512,
                                 num_layers=2, num_heads=4,
                                 parallel_residual=False),
    # GPT-J-6B: parallel residual with one shared ln_1, interleaved rotary
    # over the first 64 of 256 head dims, biasless attention, biased MLP
    # and lm_head.
    "gptj-6b": NeoXConfig(name="gptj-6b", vocab_size=50400,
                          hidden_size=4096, intermediate_size=16384,
                          num_layers=28, num_heads=16, rotary_pct=0.25,
                          parallel_residual=True, tied_norm=True,
                          attn_bias=0, rope_interleaved=True,
                          lm_head_bias=True, gelu_approximate=True),
    "debug-gptj": NeoXConfig(name="debug-gptj", vocab_size=512,
                             hidden_size=128, intermediate_size=512,
                             num_layers=2, num_heads=4, rotary_pct=0.25,
                             tied_norm=True, attn_bias=0,
                             rope_interleaved=True, lm_head_bias=True,
                             gelu_approximate=True),
}


def init_neox_params(cfg: NeoXConfig, generator: Optional[torch.Generator] = None, *,
                     dtype=torch.float32, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02), drawn on ``device`` from ``generator``
    (a new one seeded with ``seed`` when none is given); norms 1, biases 0.
    The leaves follow the config: no ``ln2`` with a tied norm, no attention
    biases without ``attn_has_bias``, no ``lm_head`` when tied."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qkv_out = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim

    def w(*shape):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * 0.02).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {"ln1_w": full(1.0, L, D), "ln1_b": full(0.0, L, D),
              "w_qkv": w(L, D, qkv_out), "w_out": w(L, D, D),
              "w_fc": w(L, D, I), "w_proj": w(L, I, D)}
    if not cfg.tied_norm:
        layers["ln2_w"] = full(1.0, L, D)
        layers["ln2_b"] = full(0.0, L, D)
    if cfg.attn_has_bias:
        layers["b_qkv"] = full(0.0, L, qkv_out)
        layers["b_out"] = full(0.0, L, D)
    if cfg.use_bias:
        layers["b_fc"] = full(0.0, L, I)
        layers["b_proj"] = full(0.0, L, D)
    params = {"wte": w(cfg.vocab_size, D), "layers": layers,
              "lnf_w": full(1.0, D), "lnf_b": full(0.0, D)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(cfg.vocab_size, D)
    if cfg.lm_head_bias:
        params["lm_head_b"] = full(0.0, cfg.vocab_size)
    return params


# --------------------------------------------------------------------------
# HF state dicts → stacked params
# --------------------------------------------------------------------------


def pack_neox_state_dict(sd, cfg: NeoXConfig, dtype=torch.float32, device=None):
    """HF ``GPTNeoXForCausalLM`` state dict → stacked params. HF fuses qkv as
    ``[(heads, 3, head_dim), D]`` rows; they are regrouped to ``[D, (3,
    heads, head_dim)]`` columns."""
    g = state_getter(sd, dtype, device)
    L, H, Dh, D = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.hidden_size
    stack = stacker(g, L)
    pre = "gpt_neox.layers.{}."

    def qkv_w(i):
        w = g(pre.format(i) + "attention.query_key_value.weight")
        return w.reshape(H, 3, Dh, D).transpose(0, 1).reshape(3 * H * Dh, D).t()

    def qkv_b(i):
        b = g(pre.format(i) + "attention.query_key_value.bias")
        return b.reshape(H, 3, Dh).transpose(0, 1).reshape(3 * H * Dh)

    params = {
        "wte": g("gpt_neox.embed_in.weight"),
        "layers": {
            "ln1_w": stack(pre + "input_layernorm.weight"),
            "ln1_b": stack(pre + "input_layernorm.bias"),
            "ln2_w": stack(pre + "post_attention_layernorm.weight"),
            "ln2_b": stack(pre + "post_attention_layernorm.bias"),
            "w_qkv": torch.stack([qkv_w(i) for i in range(L)]),
            "b_qkv": torch.stack([qkv_b(i) for i in range(L)]),
            "w_out": stack(pre + "attention.dense.weight", tr=True),
            "b_out": stack(pre + "attention.dense.bias"),
            "w_fc": stack(pre + "mlp.dense_h_to_4h.weight", tr=True),
            "b_fc": stack(pre + "mlp.dense_h_to_4h.bias"),
            "w_proj": stack(pre + "mlp.dense_4h_to_h.weight", tr=True),
            "b_proj": stack(pre + "mlp.dense_4h_to_h.bias"),
        },
        "lnf_w": g("gpt_neox.final_layer_norm.weight"),
        "lnf_b": g("gpt_neox.final_layer_norm.bias"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = g("embed_out.weight")
    return params


def pack_falcon_state_dict(sd, cfg: NeoXConfig, dtype=torch.float32, device=None):
    """HF ``FalconForCausalLM`` (7B layout: MQA, parallel tied norm) →
    stacked params. Falcon fuses qkv as ``[H*Dh + 2*Dh, D]`` rows (the q
    heads, then the shared k and v head): transposed, the column order."""
    g = state_getter(sd, dtype, device)
    stack = stacker(g, cfg.num_layers)
    pre = "transformer.h.{}."
    return {
        "wte": g("transformer.word_embeddings.weight"),
        "layers": {
            "ln1_w": stack(pre + "input_layernorm.weight"),
            "ln1_b": stack(pre + "input_layernorm.bias"),
            "w_qkv": stack(pre + "self_attention.query_key_value.weight", tr=True),
            "w_out": stack(pre + "self_attention.dense.weight", tr=True),
            "w_fc": stack(pre + "mlp.dense_h_to_4h.weight", tr=True),
            "w_proj": stack(pre + "mlp.dense_4h_to_h.weight", tr=True),
        },
        "lnf_w": g("transformer.ln_f.weight"),
        "lnf_b": g("transformer.ln_f.bias"),
    }


def pack_gptj_state_dict(sd, cfg: NeoXConfig, dtype=torch.float32, device=None):
    """HF ``GPTJForCausalLM`` state dict → stacked params: the separate q/k/v
    Linears concatenate (transposed) into the fused ``[D, 3*H*Dh]`` columns."""
    g = state_getter(sd, dtype, device)
    L = cfg.num_layers
    stack = stacker(g, L)
    pre = "transformer.h.{}."

    def qkv_w(i):
        p = pre.format(i) + "attn."
        return torch.cat([g(p + f"{n}_proj.weight").t() for n in "qkv"], dim=1)

    return {
        "wte": g("transformer.wte.weight"),
        "layers": {
            "ln1_w": stack(pre + "ln_1.weight"),
            "ln1_b": stack(pre + "ln_1.bias"),
            "w_qkv": torch.stack([qkv_w(i) for i in range(L)]),
            "w_out": stack(pre + "attn.out_proj.weight", tr=True),
            "w_fc": stack(pre + "mlp.fc_in.weight", tr=True),
            "b_fc": stack(pre + "mlp.fc_in.bias"),
            "w_proj": stack(pre + "mlp.fc_out.weight", tr=True),
            "b_proj": stack(pre + "mlp.fc_out.bias"),
        },
        "lnf_w": g("transformer.ln_f.weight"),
        "lnf_b": g("transformer.ln_f.bias"),
        "lm_head": g("lm_head.weight"),
        "lm_head_b": g("lm_head.bias"),
    }


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inv_freq(rotary_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """The rotary inverse frequencies on ``device``, built once per shape and
    device (a captured decode step reads them without a host copy)."""
    return rope_frequencies(rotary_dim, base).to(device)


def _rope_gptj(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GPT-J rotary: interleaved (even, odd) pairs within each head dim."""
    x32 = x.float()
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    c, s = cos.unsqueeze(-2), sin.unsqueeze(-2)
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape).to(x.dtype)


def _partial_rope(x: torch.Tensor, cos, sin, rotary_dim: int, interleaved: bool = False):
    """Rotate the first ``rotary_dim`` dims of each head, pass the rest."""
    rope = _rope_gptj if interleaved else apply_rope
    if rotary_dim == x.shape[-1]:
        return rope(x, cos, sin)
    return torch.cat([rope(x[..., :rotary_dim], cos, sin), x[..., rotary_dim:]], dim=-1)


def neox_forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: NeoXConfig, *,
                 cache=None, start_pos=0, kv_lens: Optional[torch.Tensor] = None,
                 attn_impl: str = "auto", compute_dtype=torch.float32, remat=False,
                 unroll: int = 1, dropout_p: float = 0.0, dropout_seed: int = 0):
    """``tokens [B, S] -> logits [B, S, V]`` float32 (no cache), or
    ``(logits, cache)`` with a :class:`~.llama.KVCache`: rotary at
    ``start_pos``, K/V written per sequence in place, ``kv_lens`` masking.
    The training knobs as :func:`~.gpt2.gpt2_forward`'s."""
    mode = training_knobs(cache, attn_impl, remat, unroll, dropout_p)
    dev = params["wte"].device
    tokens = tokens.to(dev)
    B, S = tokens.shape
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["wte"][tokens.long()].to(compute_dtype)
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    positions = start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, _inv_freq(cfg.rotary_dim, cfg.rotary_base, dev))

    def bias(lp, name, like):
        return lp[name].to(like.dtype) if name in lp else 0.0

    def heads(qkv, b_qkv):
        q, k, v = torch.split(qkv + b_qkv, [Hq * Dh, Hk * Dh, Hk * Dh], dim=-1)
        q = _partial_rope(q.reshape(B, S, Hq, Dh), cos, sin, cfg.rotary_dim,
                          cfg.rope_interleaved)
        k = _partial_rope(k.reshape(B, S, Hk, Dh), cos, sin, cfg.rotary_dim,
                          cfg.rope_interleaved)
        return q, k, v.reshape(B, S, Hk, Dh)

    def attn_branch(h, lp, attend, seg):
        a = attend(*seg(heads, _dot(h, lp["w_qkv"]), bias(lp, "b_qkv", h)))
        return _dot(a.reshape(B, S, Hq * Dh), lp["w_out"]) + bias(lp, "b_out", h)

    def mlp_act(h, b_fc):
        h = F.gelu((h + b_fc).float(), approximate="tanh" if cfg.gelu_approximate else "none")
        return h.to(compute_dtype)

    def mlp_branch(h, lp, seg):
        h = seg(mlp_act, _dot(h, lp["w_fc"]), bias(lp, "b_fc", h))
        return _dot(h, lp["w_proj"]) + bias(lp, "b_proj", h)

    def layer(x, lp, attend, seg):
        h1 = seg(layernorm, x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        if cfg.parallel_residual:
            h2 = h1 if cfg.tied_norm else seg(layernorm, x, lp["ln2_w"], lp["ln2_b"],
                                              cfg.ln_eps)
            return x + attn_branch(h1, lp, attend, seg) + mlp_branch(h2, lp, seg)
        x = x + attn_branch(h1, lp, attend, seg)
        return x + mlp_branch(seg(layernorm, x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps), lp, seg)

    x, new_cache = run_layers(params, x, layer, cache=cache, start_pos=start_pos,
                              kv_lens=kv_lens, remat=mode, dropout_p=dropout_p,
                              dropout_seed=dropout_seed)
    x = layernorm(x, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
    logits = lm_logits(params, x)
    if "lm_head_b" in params:
        logits = logits + params["lm_head_b"].float()
    return logits if cache is None else (logits, new_cache)
