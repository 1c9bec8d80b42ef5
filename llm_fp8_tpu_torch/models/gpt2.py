"""GPT-2 family: the pre-LN decoder with learned positions, LayerNorm and a
GELU MLP, and its OPT, BigCode/SantaCoder and BTLM variants (counterpart of
``llm_fp8_tpu/models/gpt2.py``; the registry is a copy, which the port keeps
since it imports nothing of the JAX package).

Parameters keep the JAX package's stacked layout (``[num_layers, ...]``
leaves, fused ``w_qkv = [q|k|v]`` columns, ``[in, out]`` weights; weights are
tensors or :class:`~..quant.QTensor`). One config covers:

* activation: ``gelu_tanh`` (GPT-2, BigCode), ``relu`` (OPT) or ``swiglu``
  (BTLM: ``w_fc`` holds the gate|up pair);
* position offset: OPT reserves the first 2 rows of its position table;
* multi-query: BigCode's single shared KV head (``num_kv_heads=1``);
* ALiBi and muP (BTLM): no position table, per-head ALiBi slopes, the muP
  embedding and logit multipliers and the 1/d attention scale.

The forward computes in float32 by default (``compute_dtype``), as the JAX
one does and as the JAX engine serves it: on the card its prefill attention
is K3's float32 instance, its projections ``qdot``'s routes with float32
activations. With a cache it runs the Llama family's cache step
(``cache_append_attend``), so the serving engine drives it through
``forward_fn``; every tensor it reads in a decode step is on the device
(ALiBi slopes cached per device), so the step can be captured as a CUDA
graph. HF GPT-2 and BTLM checkpoints store ``Conv1D [in, out]`` weights (no
transpose); OPT and BigCode store ``nn.Linear [out, in]`` (transposed).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import default_alibi_slopes
from ..ops.layernorm import layernorm
from ..utils.backend import resolve_device
from .llama import _dot
from .zoo import lm_logits, run_layers, stacker, state_getter, training_knobs

__all__ = ["GPT2Config", "GPT2_REGISTRY", "init_gpt2_params", "gpt2_forward",
           "pack_gpt2_state_dict", "pack_opt_state_dict", "pack_bigcode_state_dict",
           "pack_btlm_state_dict"]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    name: str
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = -1  # -1 = num_heads; 1 = BigCode multi-query
    max_position_embeddings: int = 1024
    activation: str = "gelu_tanh"  # "gelu_tanh" | "relu" (OPT) | "swiglu" (BTLM)
    pos_offset: int = 0  # OPT: position table rows 0-1 are reserved
    ln_eps: float = 1e-5
    inner_size: int = -1  # -1 = 4*hidden; BTLM uses a bespoke ffn width
    use_alibi: bool = False  # BTLM: alibi slopes instead of a position table
    # muP (BTLM): embedding-output multiplier, logits multiplier
    # (output_alpha * width_scale) and the 1/d attention scale.
    mup_embeddings_multiplier: float = 1.0
    mup_output_multiplier: float = 1.0
    mup_width_scale: float = 1.0
    mup_scale_qk_dot_by_d: bool = False

    def __post_init__(self):
        if self.num_kv_heads < 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def intermediate_size(self) -> int:
        return self.inner_size if self.inner_size > 0 else 4 * self.hidden_size


GPT2_REGISTRY = {
    "gpt2": GPT2Config(name="gpt2"),
    "gpt2-medium": GPT2Config(name="gpt2-medium", hidden_size=1024,
                              num_layers=24, num_heads=16),
    "gpt2-large": GPT2Config(name="gpt2-large", hidden_size=1280,
                             num_layers=36, num_heads=20),
    "gpt2-xl": GPT2Config(name="gpt2-xl", hidden_size=1600,
                          num_layers=48, num_heads=25),
    "debug-gpt2": GPT2Config(name="debug-gpt2", vocab_size=512,
                             hidden_size=128, num_layers=2, num_heads=4,
                             max_position_embeddings=256),
    # OPT family (facebook/opt-*): ReLU MLP, offset-2 learned positions.
    "opt-125m": GPT2Config(name="opt-125m", vocab_size=50272,
                           max_position_embeddings=2048,
                           activation="relu", pos_offset=2),
    "opt-1.3b": GPT2Config(name="opt-1.3b", vocab_size=50272,
                           hidden_size=2048, num_layers=24, num_heads=32,
                           max_position_embeddings=2048,
                           activation="relu", pos_offset=2),
    "debug-opt": GPT2Config(name="debug-opt", vocab_size=512,
                            hidden_size=128, num_layers=2, num_heads=4,
                            max_position_embeddings=256,
                            activation="relu", pos_offset=2),
    # BigCode (santacoder/starcoder line): GPT-2 block + multi-query KV.
    "santacoder": GPT2Config(name="santacoder", vocab_size=49280,
                             hidden_size=2048, num_layers=24, num_heads=16,
                             num_kv_heads=1,
                             max_position_embeddings=2048),
    "debug-bigcode": GPT2Config(name="debug-bigcode", vocab_size=512,
                                hidden_size=128, num_layers=2, num_heads=4,
                                num_kv_heads=1,
                                max_position_embeddings=256),
    # BTLM (cerebras/btlm-3b-8k-base): GPT-2 block + SwiGLU + ALiBi + muP.
    "btlm-3b": GPT2Config(name="btlm-3b", vocab_size=50257,
                          hidden_size=2560, num_layers=32, num_heads=32,
                          max_position_embeddings=8192, activation="swiglu",
                          inner_size=6826, use_alibi=True,
                          mup_embeddings_multiplier=14.6,
                          mup_output_multiplier=2.22, mup_width_scale=0.1,
                          mup_scale_qk_dot_by_d=True),
    "debug-btlm": GPT2Config(name="debug-btlm", vocab_size=512,
                             hidden_size=128, num_layers=2, num_heads=4,
                             max_position_embeddings=256,
                             activation="swiglu", inner_size=340,
                             use_alibi=True,
                             mup_embeddings_multiplier=14.6,
                             mup_output_multiplier=2.22,
                             mup_width_scale=0.1,
                             mup_scale_qk_dot_by_d=True),
}


def init_gpt2_params(cfg: GPT2Config, generator: Optional[torch.Generator] = None, *,
                     dtype=torch.float32, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02) (positions 0.01), drawn on ``device`` from
    ``generator`` (a new one seeded with ``seed`` when none is given); norms
    1, biases 0. SwiGLU's ``w_fc`` holds the gate|up pair; an ALiBi model's
    position table is a 1-row placeholder, as in the JAX package."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    fc_cols = 2 * I if cfg.activation == "swiglu" else I
    n_pos = 1 if cfg.use_alibi else cfg.max_position_embeddings

    def w(*shape, std=0.02):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * std).to(dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wte": w(cfg.vocab_size, D),
        "wpe": w(n_pos, D, std=0.01),
        "layers": {
            "ln1_w": full(1.0, L, D), "ln1_b": full(0.0, L, D),
            "ln2_w": full(1.0, L, D), "ln2_b": full(0.0, L, D),
            "w_qkv": w(L, D, D + 2 * cfg.kv_dim),
            "b_qkv": full(0.0, L, D + 2 * cfg.kv_dim),
            "w_out": w(L, D, D),
            "b_out": full(0.0, L, D),
            "w_fc": w(L, D, fc_cols),
            "b_fc": full(0.0, L, fc_cols),
            "w_proj": w(L, I, D),
            "b_proj": full(0.0, L, D),
        },
        "lnf_w": full(1.0, D),
        "lnf_b": full(0.0, D),
    }


# --------------------------------------------------------------------------
# HF state dicts → stacked params
# --------------------------------------------------------------------------


def _gpt2_layout(g, stack, tr: bool, h="transformer.h.{}."):
    """The GPT-2-layout parameters (``transformer.{wte,wpe,h,ln_f}``), weights
    transposed when ``tr`` (BigCode's Linears)."""
    return {
        "wte": g("transformer.wte.weight"),
        "wpe": g("transformer.wpe.weight"),
        "layers": {
            "ln1_w": stack(h + "ln_1.weight"),
            "ln1_b": stack(h + "ln_1.bias"),
            "ln2_w": stack(h + "ln_2.weight"),
            "ln2_b": stack(h + "ln_2.bias"),
            "w_qkv": stack(h + "attn.c_attn.weight", tr),
            "b_qkv": stack(h + "attn.c_attn.bias"),
            "w_out": stack(h + "attn.c_proj.weight", tr),
            "b_out": stack(h + "attn.c_proj.bias"),
            "w_fc": stack(h + "mlp.c_fc.weight", tr),
            "b_fc": stack(h + "mlp.c_fc.bias"),
            "w_proj": stack(h + "mlp.c_proj.weight", tr),
            "b_proj": stack(h + "mlp.c_proj.bias"),
        },
        "lnf_w": g("transformer.ln_f.weight"),
        "lnf_b": g("transformer.ln_f.bias"),
    }


def pack_gpt2_state_dict(sd, cfg: GPT2Config, dtype=torch.float32, device=None):
    """HF ``GPT2LMHeadModel`` state dict → stacked params (Conv1D: no transpose)."""
    g = state_getter(sd, dtype, device)
    return _gpt2_layout(g, stacker(g, cfg.num_layers), tr=False)


def pack_opt_state_dict(sd, cfg: GPT2Config, dtype=torch.float32, device=None):
    """HF ``OPTForCausalLM`` (pre-LN variants) → stacked params. The separate
    q/k/v Linears ``[out, in]`` concatenate transposed into the fused column
    layout; the offset-2 position table is kept whole (``cfg.pos_offset``
    applies at lookup)."""
    g = state_getter(sd, dtype, device)
    L, pre = cfg.num_layers, "model.decoder.layers.{}."
    stack = stacker(g, L)

    def qkv(i, kind):
        p = pre.format(i) + "self_attn."
        parts = [g(p + f"{n}_proj.{kind}") for n in "qkv"]
        return torch.cat([t.t() for t in parts], dim=1) if kind == "weight" else torch.cat(parts)

    return {
        "wte": g("model.decoder.embed_tokens.weight"),
        "wpe": g("model.decoder.embed_positions.weight"),
        "layers": {
            "ln1_w": stack(pre + "self_attn_layer_norm.weight"),
            "ln1_b": stack(pre + "self_attn_layer_norm.bias"),
            "ln2_w": stack(pre + "final_layer_norm.weight"),
            "ln2_b": stack(pre + "final_layer_norm.bias"),
            "w_qkv": torch.stack([qkv(i, "weight") for i in range(L)]),
            "b_qkv": torch.stack([qkv(i, "bias") for i in range(L)]),
            "w_out": stack(pre + "self_attn.out_proj.weight", tr=True),
            "b_out": stack(pre + "self_attn.out_proj.bias"),
            "w_fc": stack(pre + "fc1.weight", tr=True),
            "b_fc": stack(pre + "fc1.bias"),
            "w_proj": stack(pre + "fc2.weight", tr=True),
            "b_proj": stack(pre + "fc2.bias"),
        },
        "lnf_w": g("model.decoder.final_layer_norm.weight"),
        "lnf_b": g("model.decoder.final_layer_norm.bias"),
    }


def pack_bigcode_state_dict(sd, cfg: GPT2Config, dtype=torch.float32, device=None):
    """HF ``GPTBigCodeForCausalLM`` → stacked params. ``c_attn`` is a Linear
    ``[D + 2*kv_dim, D]`` with the shared KV head after the query heads:
    transposed, the fused column layout."""
    g = state_getter(sd, dtype, device)
    return _gpt2_layout(g, stacker(g, cfg.num_layers), tr=True)


def pack_btlm_state_dict(sd, cfg: GPT2Config, dtype=torch.float32, device=None):
    """HF ``BTLMLMHeadModel`` (cerebras) → stacked params: Conv1D ``[in,
    out]`` weights as GPT-2, the SwiGLU pair ``c_fc`` (gate) / ``c_fc2`` (up)
    fused into ``w_fc``, and no position table in the checkpoint (ALiBi; a
    1-row zero placeholder)."""
    g = state_getter(sd, dtype, device)
    L = cfg.num_layers
    stack = stacker(g, L)
    h = "transformer.h.{}."
    fc_w = [torch.cat([g(f"transformer.h.{i}.mlp.c_fc.weight"),
                       g(f"transformer.h.{i}.mlp.c_fc2.weight")], dim=1) for i in range(L)]
    fc_b = [torch.cat([g(f"transformer.h.{i}.mlp.c_fc.bias"),
                       g(f"transformer.h.{i}.mlp.c_fc2.bias")]) for i in range(L)]
    wte = g("transformer.wte.weight")
    return {
        "wte": wte,
        "wpe": torch.zeros((1, cfg.hidden_size), dtype=dtype, device=wte.device),
        "layers": {
            "ln1_w": stack(h + "ln_1.weight"),
            "ln1_b": stack(h + "ln_1.bias"),
            "ln2_w": stack(h + "ln_2.weight"),
            "ln2_b": stack(h + "ln_2.bias"),
            "w_qkv": stack(h + "attn.c_attn.weight"),
            "b_qkv": stack(h + "attn.c_attn.bias"),
            "w_out": stack(h + "attn.c_proj.weight"),
            "b_out": stack(h + "attn.c_proj.bias"),
            "w_fc": torch.stack(fc_w),
            "b_fc": torch.stack(fc_b),
            "w_proj": stack(h + "mlp.c_proj.weight"),
            "b_proj": stack(h + "mlp.c_proj.bias"),
        },
        "lnf_w": g("transformer.ln_f.weight"),
        "lnf_b": g("transformer.ln_f.bias"),
    }


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _activation(h: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP's activation in float32, back in h's dtype; SwiGLU splits
    ``h`` into gate|up."""
    if kind == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        return F.silu(gate.float()).to(up.dtype) * up
    if kind == "relu":
        return F.relu(h.float()).to(h.dtype)
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def gpt2_forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: GPT2Config, *,
                 cache=None, start_pos=0, kv_lens: Optional[torch.Tensor] = None,
                 attn_impl: str = "auto", compute_dtype=torch.float32, remat=False,
                 unroll: int = 1, dropout_p: float = 0.0, dropout_seed: int = 0):
    """``tokens [B, S] -> logits [B, S, V]`` float32 (no cache), or
    ``(logits, cache)`` with a :class:`~.llama.KVCache`: K/V written at each
    sequence's ``start_pos`` in place, attention masked to ``kv_lens``.

    ``remat``/``unroll``/``dropout_p``/``dropout_seed``: the training knobs
    with the Llama family's semantics (``zoo.run_layers``), so the shared
    ``Trainer(forward_fn=...)`` drives this family too; ``attn_impl`` is
    ``"auto"`` only and ``unroll`` 1 only (``zoo.training_knobs``)."""
    mode = training_knobs(cache, attn_impl, remat, unroll, dropout_p)
    dev = params["wte"].device
    tokens = tokens.to(dev)
    B, S = tokens.shape
    D, H, Hk, Dh = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = params["wte"][tokens.long()].to(compute_dtype)
    if cfg.mup_embeddings_multiplier != 1.0:
        x = x * cfg.mup_embeddings_multiplier
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    slopes = None
    if cfg.use_alibi:
        slopes = default_alibi_slopes(H, dev)
    else:
        pos = (start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
               + cfg.pos_offset)
        x = x + params["wpe"][pos.long()].to(x.dtype)

    def heads(qkv, b_qkv):
        q, k, v = torch.split(qkv + b_qkv.to(qkv.dtype), [D, cfg.kv_dim, cfg.kv_dim], dim=-1)
        return q.reshape(B, S, H, Dh), k.reshape(B, S, Hk, Dh), v.reshape(B, S, Hk, Dh)

    def mlp_act(h, b_fc):
        return _activation(h + b_fc.to(h.dtype), cfg.activation)

    def layer(x, lp, attend, seg):
        h = seg(layernorm, x, lp["ln1_w"], lp["ln1_b"], cfg.ln_eps)
        a = attend(*seg(heads, _dot(h, lp["w_qkv"]), lp["b_qkv"]))
        x = x + _dot(a.reshape(B, S, D), lp["w_out"]) + lp["b_out"].to(x.dtype)
        h = seg(layernorm, x, lp["ln2_w"], lp["ln2_b"], cfg.ln_eps)
        h = seg(mlp_act, _dot(h, lp["w_fc"]), lp["b_fc"])
        return x + _dot(h, lp["w_proj"]) + lp["b_proj"].to(x.dtype)

    # As in the JAX forward, kv_lens masks the cache path only.
    x, new_cache = run_layers(params, x, layer, cache=cache, start_pos=start_pos,
                              kv_lens=None if cache is None else kv_lens, remat=mode,
                              dropout_p=dropout_p, dropout_seed=dropout_seed,
                              scale=(1.0 / Dh) if cfg.mup_scale_qk_dot_by_d else None,
                              alibi_slopes=slopes)
    x = layernorm(x, params["lnf_w"], params["lnf_b"], cfg.ln_eps)
    logits = lm_logits(params, x)
    out_scale = cfg.mup_output_multiplier * cfg.mup_width_scale
    if out_scale != 1.0:
        logits = logits * out_scale
    return logits if cache is None else (logits, new_cache)
