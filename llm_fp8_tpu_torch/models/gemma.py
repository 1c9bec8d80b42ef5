"""Gemma-2 (counterpart of ``llm_fp8_tpu/models/gemma.py``; the registry is a
copy): the softcap and sliding-window kernel levers as a model.

Numerics as HF ``Gemma2ForCausalLM`` (and the JAX forward):

* RMSNorm multiplies by ``(1 + w)`` in float32 (zero-initialised weights);
* four norms a layer: pre/post attention and pre/post feed-forward, the
  post-norms applied to the block's output before the residual add;
* GeGLU MLP: ``down(gelu_tanh(gate(x)) * up(x))``, the gelu in float32;
* embeddings scaled by ``sqrt(hidden_size)`` rounded to the compute dtype
  (sqrt(3584) = 59.87 is not a bf16 value);
* attention scale ``query_pre_attn_scalar ** -0.5``, the attention logits
  capped at ``attn_logit_softcap``, a sliding window on even layers only;
* the tied head as a product in the compute dtype with float32 output, then
  the final cap ``tanh(l / cap) · cap``.

It computes in bf16 by default (``compute_dtype``), as the JAX forward: on
the card its prefill and training attention is K3's bf16 instance at head
dim 256 and its backward K6's; decode (one query) takes the plain
``decode_attention``, as JAX's decode fast path is XLA. Where JAX scans over
(sliding, full) layer pairs so that each half has a static window, the
port's layer loop gives each layer its own window
(``models/zoo.py::run_layers``). The parameter leaves are the Llama
family's names plus ``norm_attn_post``/``norm_mlp_post``, so the Llama
family's ``quantize_params`` quantizes its four GEMM sites, as in JAX.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.rmsnorm import rmsnorm
from ..ops.rotary import apply_rope, rope_cos_sin
from ..utils.backend import resolve_device
from .config import ModelConfig
from .llama import _dot, _inv_freq
from .zoo import lm_logits, run_layers, state_getter, training_knobs

__all__ = ["GemmaConfig", "GEMMA_REGISTRY", "init_gemma_params", "gemma_forward",
           "pack_gemma2_state_dict", "layer_window"]


@dataclasses.dataclass(frozen=True)
class GemmaConfig(ModelConfig):
    """Gemma-2. ``sliding_window`` applies to EVEN layers only (HF
    ``layer_types``: sliding for even indices, full for odd); ``num_layers``
    must be even, as the JAX forward's pair scan needs it."""

    query_pre_attn_scalar: float = 256.0
    attn_logit_softcap: Optional[float] = 50.0
    final_logit_softcap: Optional[float] = 30.0

    def __post_init__(self):
        if self.num_layers % 2 != 0:
            raise ValueError("Gemma-2 pair-scan needs an even num_layers")


GEMMA_REGISTRY: Dict[str, GemmaConfig] = {
    # google/gemma-2-2b config.json.
    "gemma2-2b": GemmaConfig(
        name="gemma2-2b", vocab_size=256000, hidden_size=2304,
        intermediate_size=9216, num_layers=26, num_heads=8, num_kv_heads=4,
        head_dim=256, rope_theta=10000.0, rms_eps=1e-6,
        max_position_embeddings=8192, sliding_window=4096,
        query_pre_attn_scalar=256.0, tie_word_embeddings=True,
    ),
    # google/gemma-2-9b config.json.
    "gemma2-9b": GemmaConfig(
        name="gemma2-9b", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_layers=42, num_heads=16,
        num_kv_heads=8, head_dim=256, rope_theta=10000.0, rms_eps=1e-6,
        max_position_embeddings=8192, sliding_window=4096,
        query_pre_attn_scalar=256.0, tie_word_embeddings=True,
    ),
    "debug-gemma2": GemmaConfig(
        name="debug-gemma2", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, rope_theta=10000.0, rms_eps=1e-6,
        max_position_embeddings=2048, sliding_window=6,
        query_pre_attn_scalar=32.0, tie_word_embeddings=True,
    ),
}


def layer_window(cfg: GemmaConfig, li: int) -> Optional[int]:
    """Layer ``li``'s attention window: ``sliding_window`` on even global
    indices, None (full causal) on odd ones."""
    return cfg.sliding_window if li % 2 == 0 else None


def init_gemma_params(cfg: GemmaConfig, generator: Optional[torch.Generator] = None, *,
                      dtype=torch.bfloat16, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02), drawn on ``device`` from ``generator``
    (a new one seeded with ``seed`` when none is given); the norms are
    zero-initialised residual weights (applied as ``1 + w``)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

    def w(*shape):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {"wqkv": w(L, D, cfg.qkv_dim), "wo": w(L, cfg.q_dim, D),
              "w_gate_up": w(L, D, 2 * I), "w_down": w(L, I, D),
              "norm_attn": zeros(L, D), "norm_attn_post": zeros(L, D),
              "norm_mlp": zeros(L, D), "norm_mlp_post": zeros(L, D)}
    return {"embed": w(V, D), "layers": layers, "final_norm": zeros(D)}


#: HF Gemma2 norm names of each layer's four norms.
_NORMS = (("norm_attn", "input_layernorm"), ("norm_attn_post", "post_attention_layernorm"),
          ("norm_mlp", "pre_feedforward_layernorm"),
          ("norm_mlp_post", "post_feedforward_layernorm"))


def pack_gemma2_state_dict(sd, cfg: GemmaConfig, dtype=torch.bfloat16, device=None):
    """HF ``Gemma2ForCausalLM`` state dict → stacked params: q/k/v fused into
    ``wqkv`` and gate|up into ``w_gate_up`` (each Linear transposed), the
    four norms stacked. A missing tensor raises ``KeyError`` naming it."""
    get = state_getter(sd, dtype, device)

    def g(name):
        if name not in sd:
            raise KeyError(f"missing {name!r} in checkpoint")
        return get(name)

    def linear(name):
        return g(name).t()

    cols = {k: [] for k in ("wqkv", "wo", "w_gate_up", "w_down", *(n for n, _ in _NORMS))}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        cols["wqkv"].append(torch.cat([linear(p + f"self_attn.{n}_proj.weight")
                                       for n in "qkv"], dim=1))
        cols["wo"].append(linear(p + "self_attn.o_proj.weight"))
        cols["w_gate_up"].append(torch.cat([linear(p + "mlp.gate_proj.weight"),
                                            linear(p + "mlp.up_proj.weight")], dim=1))
        cols["w_down"].append(linear(p + "mlp.down_proj.weight"))
        for ours, theirs in _NORMS:
            cols[ours].append(g(p + theirs + ".weight"))
    return {"embed": g("model.embed_tokens.weight"),
            "layers": {k: torch.stack(v) for k, v in cols.items()},
            "final_norm": g("model.norm.weight")}


def _gnorm(x, w, eps):
    """Gemma RMSNorm: multiply by ``(1 + w)`` in float32, as HF Gemma2RMSNorm."""
    return rmsnorm(x, w.float() + 1.0, eps)


def _geglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return F.gelu(gate.float(), approximate="tanh").to(up.dtype) * up


def gemma_forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: GemmaConfig, *,
                  cache=None, start_pos=0, kv_lens: Optional[torch.Tensor] = None,
                  attn_impl: str = "auto", compute_dtype=torch.bfloat16, remat=False,
                  unroll: int = 1, dropout_p: float = 0.0, dropout_seed: int = 0):
    """``tokens [B, S] -> logits [B, S, V]`` float32 (no cache), or
    ``(logits, cache)`` with a :class:`~.llama.KVCache`: rotary at
    ``start_pos``, K/V written per sequence in place, ``kv_lens`` masking.
    The training knobs (``remat`` none/full/dots, ``dropout_p`` with layer
    li's seed ``dropout_seed + li·7919``) as :func:`~.gpt2.gpt2_forward`'s."""
    mode = training_knobs(cache, attn_impl, remat, unroll, dropout_p)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    B, S = tokens.shape
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.rms_eps
    x = params["embed"][tokens.long()].to(compute_dtype)
    # HF scales by the normaliser in the activation dtype: rounded first (on
    # the host: a captured decode step may copy nothing to the device).
    x = x * float(torch.tensor(math.sqrt(cfg.hidden_size), dtype=compute_dtype))
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    positions = start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, _inv_freq(Dh, cfg.rope_theta, None, dev))

    def heads(qkv):
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        return (apply_rope(q.reshape(B, S, Hq, Dh), cos, sin),
                apply_rope(k.reshape(B, S, Hk, Dh), cos, sin), v.reshape(B, S, Hk, Dh))

    def layer(x, lp, attend, seg):
        h = seg(_gnorm, x, lp["norm_attn"], eps)
        attn = attend(*seg(heads, _dot(h, lp["wqkv"])))
        o = _dot(attn.reshape(B, S, Hq * Dh), lp["wo"])
        x = x + seg(_gnorm, o, lp["norm_attn_post"], eps)
        h = seg(_gnorm, x, lp["norm_mlp"], eps)
        down = _dot(seg(_geglu, _dot(h, lp["w_gate_up"])), lp["w_down"])
        return x + seg(_gnorm, down, lp["norm_mlp_post"], eps)

    x, new_cache = run_layers(params, x, layer, cache=cache, start_pos=start_pos,
                              kv_lens=kv_lens, remat=mode, dropout_p=dropout_p,
                              dropout_seed=dropout_seed, window=lambda li: layer_window(cfg, li),
                              scale=float(cfg.query_pre_attn_scalar) ** -0.5,
                              softcap=cfg.attn_logit_softcap)
    logits = lm_logits(params, _gnorm(x, params["final_norm"], eps))
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits if cache is None else (logits, new_cache)
