"""DeepSeek-V2 family: Multi-head Latent Attention and DeepSeekMoE
(counterpart of ``llm_fp8_tpu/models/mla.py``; the registry is a copy),
numerics as HF ``DeepseekV2ForCausalLM`` and the JAX forward.

* Queries: a direct ``wq`` (V2-Lite) or ``wq_a → RMSNorm → wq_b`` (V2); per
  head a ``qk_nope_head_dim`` content part and a ``qk_rope_head_dim``
  rotary part.
* Keys and values: ``w_kv_a`` maps the hidden state to a ``kv_lora_rank``
  latent ``c`` (RMSNormed) and one shared rotary slice ``k_pe``; ``w_kv_b``
  expands ``c`` to per-head (k_nope, v). The rotary is interleaved (even,
  odd pairs: ``neox._rope_gptj``); the softmax scale is ``qk_head_dim **
  -0.5``.
* MLP: the first ``first_k_dense_replace`` layers dense SwiGLU, the rest
  DeepSeekMoE: a float32 softmax over all experts, a greedy or
  group-limited top-k with JAX's tie order (``moe.top_k``), no
  renormalization, weights times ``routed_scaling_factor``, GShard
  dispatch (``moe.dispatch_experts``; lossless with a cache), plus
  always-on shared experts. The parameters are two stacked groups,
  ``dense_layers`` and ``moe_layers``; layer indices run 0.. across both.

Without a cache (training, the HF-parity forward) the latent is expanded to
per-head K/V and attention is ``ops.attention`` with V zero-padded to the
qk head dim and the scale given explicitly: K3 bf16 on the card (head dim
192, or 24 at debug size, both zero-padded to an instance by the kernel's
wrapper), K6 in the backward. With a cache the family serves over the
*latent* cache: ``init_kv_cache`` builds ``k [L, B, T, 1, kv_lora_rank]``
(the normalized ``c``) and ``v [L, B, T, 1, qk_rope_head_dim]`` (the
post-rope ``k_pe``) from :meth:`MLAConfig.kv_cache_dims`; each call writes
its rows in place (clip-then-cast into a narrower arena, as JAX) and
attends as absorbed-matmul MQA in latent space: the float32 einsums of
JAX's ``_mla_attend_latent``, plain torch as they are XLA there (no
attention kernel runs on the serving path). Nothing in it syncs with the
host, so the engine's decode step and the speculative round capture as
CUDA graphs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.rmsnorm import rmsnorm
from ..ops.rotary import rope_cos_sin
from ..quant import QTensor, RecipeSet, quantize, quantize_mx
from ..quant.dot import serving_layout
from ..utils.backend import resolve_device
from .config import ModelConfig
from .llama import (DROPOUT_LAYER_STRIDE, _call, _ckpt, _dot, _inv_freq, _lm_head, _swiglu,
                    quantize_kv, unstack_layers)
from .moe import dispatch_experts, load_balance_loss, top_k
from .neox import _rope_gptj as _rope_interleaved
from .zoo import state_getter, training_knobs

__all__ = ["MLAConfig", "MLA_REGISTRY", "init_mla_params", "mla_forward",
           "pack_deepseek_state_dict", "export_deepseek_state_dict", "quantize_mla_params",
           "deepseek_gate"]


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """DeepSeek-V2: MLA attention + DeepSeekMoE FFN. ``num_kv_heads`` is the
    latent cache's one shared store; ``head_dim`` the qk head dim (for
    bookkeeping); ``intermediate_size`` the dense layers' MLP width."""

    q_lora_rank: Optional[int] = None      # None = direct q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 64                  # n_routed_experts
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    moe_intermediate_size: int = 1408
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"            # or "group_limited_greedy" (V2)
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    capacity_factor: float = 2.0
    moe_group_size: int = 512
    router_aux_coef: float = 0.001         # HF aux_loss_alpha default

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def kv_cache_dims(self) -> Tuple[int, int, int]:
        """``(stores, K width, V width)`` of the latent cache: K = the
        normalized latent, V = the shared post-rope slice."""
        return (1, self.kv_lora_rank, self.qk_rope_head_dim)

    def num_params(self) -> int:
        d, v = self.hidden_size, self.vocab_size
        H, dn, dr, dv = (self.num_heads, self.qk_nope_head_dim, self.qk_rope_head_dim,
                         self.v_head_dim)
        r, qr = self.kv_lora_rank, self.q_lora_rank
        q_p = d * H * (dn + dr) if qr is None else d * qr + qr + qr * H * (dn + dr)
        attn = q_p + d * (r + dr) + r + r * H * (dn + dv) + H * dv * d
        dense = 3 * d * self.intermediate_size
        Im, E, S = self.moe_intermediate_size, self.num_experts, self.n_shared_experts
        moe = d * E + E * 3 * d * Im + 3 * d * (Im * S)
        Kd = self.first_k_dense_replace
        total = self.num_layers * (attn + 2 * d) + Kd * dense + (self.num_layers - Kd) * moe
        return total + v * d * (1 if self.tie_word_embeddings else 2) + d


def _mla(name: str, **kw) -> MLAConfig:
    base = dict(name=name, rope_theta=10000.0, rms_eps=1e-6, num_kv_heads=1)
    base.update(kw)
    return MLAConfig(**base)


#: Both published DeepSeek-V2 checkpoints' yarn dict (config.json
#: ``rope_scaling``); mscale == mscale_all_dim makes the cos/sin factor 1.
_DEEPSEEK_YARN = dict(rope_type="yarn", factor=40.0, beta_fast=32, beta_slow=1, mscale=0.707,
                      mscale_all_dim=0.707, original_max_position_embeddings=4096)

MLA_REGISTRY: Dict[str, MLAConfig] = {
    # deepseek-ai/DeepSeek-V2-Lite config.json: 27 layers, 16 heads, direct
    # q_proj, greedy top-6 of 64 routed + 2 shared experts, first layer dense.
    "deepseek-v2-lite": _mla(
        "deepseek-v2-lite", vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        num_layers=27, num_heads=16, head_dim=192, q_lora_rank=None, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, num_experts=64,
        num_experts_per_tok=6, n_shared_experts=2, moe_intermediate_size=1408,
        first_k_dense_replace=1, routed_scaling_factor=1.0, topk_method="greedy",
        max_position_embeddings=163840, rope_scaling=_DEEPSEEK_YARN),
    # deepseek-ai/DeepSeek-V2: 60 layers, 128 heads, low-rank q (1536),
    # group-limited top-6 of 160 routed experts (best 3 of 8 groups), x16.
    "deepseek-v2": _mla(
        "deepseek-v2", vocab_size=102400, hidden_size=5120, intermediate_size=12288,
        num_layers=60, num_heads=128, head_dim=192, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, num_experts=160,
        num_experts_per_tok=6, n_shared_experts=2, moe_intermediate_size=1536,
        first_k_dense_replace=1, routed_scaling_factor=16.0,
        topk_method="group_limited_greedy", n_group=8, topk_group=3,
        max_position_embeddings=163840, rope_scaling=_DEEPSEEK_YARN),
    "debug-mla": _mla(
        "debug-mla", vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=4, head_dim=24, q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, num_experts=4, num_experts_per_tok=2,
        n_shared_experts=1, moe_intermediate_size=64, first_k_dense_replace=1,
        max_position_embeddings=2048),
    # The low-rank q path, V2's group-limited gate and a routed scale.
    "debug-mla-q": _mla(
        "debug-mla-q", vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=3,
        num_heads=4, head_dim=24, q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, num_experts=8, num_experts_per_tok=2,
        n_shared_experts=1, moe_intermediate_size=64, first_k_dense_replace=1,
        routed_scaling_factor=2.5, topk_method="group_limited_greedy", n_group=2,
        topk_group=1, max_position_embeddings=2048),
}


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------


def init_mla_params(cfg: MLAConfig, generator: Optional[torch.Generator] = None, *,
                    dtype=torch.bfloat16, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02), drawn on ``device`` from ``generator``
    (a new one seeded with ``seed`` when none is given) a layer at a time,
    so the float32 draw of a stacked leaf never holds more than one layer
    (DeepSeek-V2-Lite's 26 layers of experts are 38 GB in float32); norms
    1. The leaves and shapes are JAX's: ``dense_layers``
    (``first_k_dense_replace`` layers) and ``moe_layers`` (the rest), each
    stacked."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    Kd = cfg.first_k_dense_replace
    Lm = L - Kd
    E, Im = cfg.num_experts, cfg.moe_intermediate_size
    Is, I = Im * cfg.n_shared_experts, cfg.intermediate_size

    def draw(shape):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * 0.02).to(dtype)

    def w(*shape):
        if len(shape) < 3:
            return draw(shape)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = draw(shape[1:])
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def attn_leaves(n):
        lv = {"w_kv_a": w(n, D, r + dr), "norm_kv": ones(n, r),
              "w_kv_b": w(n, r, H * (dn + dv)), "wo": w(n, H * dv, D),
              "norm_attn": ones(n, D), "norm_mlp": ones(n, D)}
        if qr is None:
            lv["wq"] = w(n, D, H * (dn + dr))
        else:
            lv.update(wq_a=w(n, D, qr), norm_q=ones(n, qr), wq_b=w(n, qr, H * (dn + dr)))
        return lv

    dense = attn_leaves(Kd)
    dense.update(w_gate_up=w(Kd, D, 2 * I), w_down=w(Kd, I, D))
    moe = attn_leaves(Lm)
    moe.update(w_router=w(Lm, D, E), w_gate_up=w(Lm, E, D, 2 * Im), w_down=w(Lm, E, Im, D),
               w_shared_gate_up=w(Lm, D, 2 * Is), w_shared_down=w(Lm, Is, D))
    params = {"embed": w(V, D), "dense_layers": dense, "moe_layers": moe,
              "final_norm": ones(D)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(D, V)
    return params


def pack_deepseek_state_dict(sd, cfg: MLAConfig, dtype=torch.bfloat16,
                             device=None) -> Dict[str, Any]:
    """HF ``DeepseekV2ForCausalLM`` state dict → the stacked two-group
    params (Linears transposed, each expert's gate|up fused and the experts
    stacked on a leading E axis). A missing tensor raises ``KeyError``."""
    get = state_getter(sd, dtype, device)

    def g(name):
        if name not in sd:
            raise KeyError(f"missing {name!r} in checkpoint")
        return get(name)

    def lin(name):
        return g(name).t()

    Kd = cfg.first_k_dense_replace
    groups: Dict[str, Dict[str, list]] = {"dense": {}, "moe": {}}

    def put(group, leaf, t):
        groups[group].setdefault(leaf, []).append(t)

    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        grp = "dense" if i < Kd else "moe"
        if cfg.q_lora_rank is None:
            put(grp, "wq", lin(p + "self_attn.q_proj.weight"))
        else:
            put(grp, "wq_a", lin(p + "self_attn.q_a_proj.weight"))
            put(grp, "norm_q", g(p + "self_attn.q_a_layernorm.weight"))
            put(grp, "wq_b", lin(p + "self_attn.q_b_proj.weight"))
        put(grp, "w_kv_a", lin(p + "self_attn.kv_a_proj_with_mqa.weight"))
        put(grp, "norm_kv", g(p + "self_attn.kv_a_layernorm.weight"))
        put(grp, "w_kv_b", lin(p + "self_attn.kv_b_proj.weight"))
        put(grp, "wo", lin(p + "self_attn.o_proj.weight"))
        put(grp, "norm_attn", g(p + "input_layernorm.weight"))
        put(grp, "norm_mlp", g(p + "post_attention_layernorm.weight"))
        if grp == "dense":
            put(grp, "w_gate_up", torch.cat([lin(p + "mlp.gate_proj.weight"),
                                             lin(p + "mlp.up_proj.weight")], dim=1))
            put(grp, "w_down", lin(p + "mlp.down_proj.weight"))
        else:
            put(grp, "w_router", lin(p + "mlp.gate.weight"))
            ep = [p + f"mlp.experts.{e}." for e in range(cfg.num_experts)]
            put(grp, "w_gate_up", torch.stack([
                torch.cat([lin(x + "gate_proj.weight"), lin(x + "up_proj.weight")], dim=1)
                for x in ep]))
            put(grp, "w_down", torch.stack([lin(x + "down_proj.weight") for x in ep]))
            put(grp, "w_shared_gate_up",
                torch.cat([lin(p + "mlp.shared_experts.gate_proj.weight"),
                           lin(p + "mlp.shared_experts.up_proj.weight")], dim=1))
            put(grp, "w_shared_down", lin(p + "mlp.shared_experts.down_proj.weight"))
    params: Dict[str, Any] = {
        "embed": g("model.embed_tokens.weight"),
        "dense_layers": {k: torch.stack(v) for k, v in groups["dense"].items()},
        "moe_layers": {k: torch.stack(v) for k, v in groups["moe"].items()},
        "final_norm": g("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = lin("lm_head.weight")
    return params


def export_deepseek_state_dict(params: Dict[str, Any], cfg: MLAConfig
                               ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`pack_deepseek_state_dict`: stacked MLA params → HF
    DeepseekV2 names, float32 numpy arrays. Quantized leaves must be
    dequantized by the caller."""
    out: Dict[str, np.ndarray] = {}

    def put(name, t):
        out[name] = t.detach().float().cpu().contiguous().numpy()

    put("model.embed_tokens.weight", params["embed"])
    put("model.norm.weight", params["final_norm"])
    if "lm_head" in params:
        put("lm_head.weight", params["lm_head"].t())
    Kd, I = cfg.first_k_dense_replace, cfg.intermediate_size
    Im = cfg.moe_intermediate_size
    Is = Im * cfg.n_shared_experts
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        dense = i < Kd
        lp = params["dense_layers" if dense else "moe_layers"]
        j = i if dense else i - Kd
        if cfg.q_lora_rank is None:
            put(p + "self_attn.q_proj.weight", lp["wq"][j].t())
        else:
            put(p + "self_attn.q_a_proj.weight", lp["wq_a"][j].t())
            put(p + "self_attn.q_a_layernorm.weight", lp["norm_q"][j])
            put(p + "self_attn.q_b_proj.weight", lp["wq_b"][j].t())
        put(p + "self_attn.kv_a_proj_with_mqa.weight", lp["w_kv_a"][j].t())
        put(p + "self_attn.kv_a_layernorm.weight", lp["norm_kv"][j])
        put(p + "self_attn.kv_b_proj.weight", lp["w_kv_b"][j].t())
        put(p + "self_attn.o_proj.weight", lp["wo"][j].t())
        put(p + "input_layernorm.weight", lp["norm_attn"][j])
        put(p + "post_attention_layernorm.weight", lp["norm_mlp"][j])
        if dense:
            gu = lp["w_gate_up"][j]
            put(p + "mlp.gate_proj.weight", gu[:, :I].t())
            put(p + "mlp.up_proj.weight", gu[:, I:].t())
            put(p + "mlp.down_proj.weight", lp["w_down"][j].t())
        else:
            put(p + "mlp.gate.weight", lp["w_router"][j].t())
            for e in range(cfg.num_experts):
                ep = p + f"mlp.experts.{e}."
                gu = lp["w_gate_up"][j, e]
                put(ep + "gate_proj.weight", gu[:, :Im].t())
                put(ep + "up_proj.weight", gu[:, Im:].t())
                put(ep + "down_proj.weight", lp["w_down"][j, e].t())
            sgu = lp["w_shared_gate_up"][j]
            put(p + "mlp.shared_experts.gate_proj.weight", sgu[:, :Is].t())
            put(p + "mlp.shared_experts.up_proj.weight", sgu[:, Is:].t())
            put(p + "mlp.shared_experts.down_proj.weight", lp["w_shared_down"][j].t())
    return out


#: The projections of a layer quantized along their contraction (axis 1):
#: leaf → recipe-set role. The routed experts (axis 2) are apart.
_ATTN_SITES = {"wq": "attn_qkv", "wq_a": "attn_qkv", "wq_b": "attn_qkv",
               "w_kv_a": "attn_qkv", "w_kv_b": "attn_qkv", "wo": "attn_out"}


def quantize_mla_params(params: Dict[str, Any], recipes: RecipeSet) -> Dict[str, Any]:
    """Prequantize for serving (JAX ``quantize_mla_params``): per-output-
    channel scales along each weight's contraction (MX blocks along it for
    the block recipe), subnormal codes flushed. The 2-D-per-layer leaves
    (the attention projections, the dense MLP, the shared experts) have
    their codes laid out for the ``qdot`` route in force
    (``serving_layout``); the routed experts' ``[Lm, E, K, N]`` codes (axis
    2) stay in JAX's row-major layout, which the expert products read as it
    is. Routers and norms stay high precision; ``lm_head`` is quantized only
    where its role has a recipe."""
    out = dict(params)

    def qz(layers, name, role, axis):
        recipe = recipes.for_role(role)
        if recipe is None or name not in layers:
            return
        wv = layers[name].float()
        if recipe.granularity == "block32":
            layers[name] = quantize_mx(wv, recipe.fmt_fwd, block_axis=axis, flush_subnormal=True)
        else:
            q = quantize(wv, recipe.fmt_fwd, axes=(axis,), margin=recipe.margin,
                         group_size=recipe.group_size, flush_subnormal=True)
            layers[name] = serving_layout(q) if axis == 1 else q
        del wv

    for gname in ("dense_layers", "moe_layers"):
        layers = dict(params[gname])
        for name, role in _ATTN_SITES.items():
            qz(layers, name, role, 1)
        if gname == "dense_layers":
            qz(layers, "w_gate_up", "mlp", 1)
            qz(layers, "w_down", "mlp", 1)
        else:
            qz(layers, "w_gate_up", "mlp", 2)
            qz(layers, "w_down", "mlp", 2)
            qz(layers, "w_shared_gate_up", "mlp", 1)
            qz(layers, "w_shared_down", "mlp", 1)
        out[gname] = layers
    lm_recipe = recipes.for_role("lm_head")
    if lm_recipe is not None and "lm_head" in out:
        out["lm_head"] = serving_layout(quantize(out["lm_head"].float(), lm_recipe.fmt_fwd,
                                                 axes=(0,), flush_subnormal=True))
    return out


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def _asarray(w, dtype) -> torch.Tensor:
    """A weight's logical value in ``dtype`` (a QTensor dequantized: on the
    fp8native layout its codes are a K-major view whose logical shape is
    the weight's)."""
    return w.dequantize(dtype) if isinstance(w, QTensor) else w.to(dtype)


def _project_q(h, lp, cfg: MLAConfig) -> torch.Tensor:
    """hidden → ``[B, S, H, dn + dr]`` queries (direct or low-rank)."""
    if cfg.q_lora_rank is None:
        q = _dot(h, lp["wq"])
    else:
        q = _dot(rmsnorm(_dot(h, lp["wq_a"]), lp["norm_q"], cfg.rms_eps), lp["wq_b"])
    B, S = h.shape[:2]
    return q.reshape(B, S, cfg.num_heads, cfg.qk_head_dim)


def _rope_q(q, cos, sin, cfg: MLAConfig):
    """``(q_nope, q_pe)`` with the rotary on ``q_pe``."""
    q_nope, q_pe = torch.split(q, [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, _rope_interleaved(q_pe, cos, sin)


def _latent_parts(ckv, norm_kv, cos, sin, cfg: MLAConfig):
    """``w_kv_a``'s output → ``(c [B, S, r]`` normalized, ``k_pe [B, S, dr]``
    post-rope)."""
    c, k_pe = torch.split(ckv, [cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c = rmsnorm(c, norm_kv, cfg.rms_eps)
    return c, _rope_interleaved(k_pe[:, :, None, :], cos, sin)[:, :, 0, :]


def _expanded_qkv(q, kv, k_pe, cos, sin, cfg: MLAConfig):
    """Per-head q, k and v of the expanded attention: k = [k_nope, k_pe
    broadcast], q = [q_nope, rope(q_pe)], v zero-padded to the qk head dim."""
    B, S, H = q.shape[:3]
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _rope_q(q, cos, sin, cfg)
    k_nope, v = torch.split(kv.reshape(B, S, H, dn + dv), [dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    if dv != dn + dr:
        v = F.pad(v, (0, dn + dr - dv))
    return q, k, v


def _mla_attn_expanded(h, lp, cfg: MLAConfig, cos, sin, kv_lens, dropout_p, dropout_seed,
                       seg=_call):
    """Training/parity attention (JAX ``_mla_attn_expanded``): the latent
    expanded to per-head K/V, causal attention at scale ``qk_head_dim **
    -0.5`` (K3 on the card), V's padding sliced off the output."""
    B, S, _ = h.shape
    dq, dv = cfg.qk_head_dim, cfg.v_head_dim
    q = _project_q(h, lp, cfg)
    c, k_pe = seg(_latent_parts, _dot(h, lp["w_kv_a"]), lp["norm_kv"], cos, sin, cfg)
    q, k, v = seg(_expanded_qkv, q, _dot(c, lp["w_kv_b"]), k_pe, cos, sin, cfg)
    o = attention(q, k, v, causal=True, kv_lens=kv_lens, scale=dq ** -0.5,
                  dropout_p=dropout_p, dropout_seed=dropout_seed)
    return o[..., :dv].reshape(B, S, cfg.num_heads * dv)


def _mla_attend_latent(q_nope, q_pe, c_all, pe_all, w_uk, w_uv, cfg: MLAConfig, start_pos,
                       kv_lens):
    """Absorbed-matmul MQA over the latent cache (JAX ``_mla_attend_latent``):
    ``q_nope [B, S, H, dn]``, ``q_pe [B, S, H, dr]`` post-rope, ``c_all [B,
    T, r]``, ``pe_all [B, T, dr]``, ``w_uk [H, dn, r]``, ``w_uv [H, r, dv]``;
    float32 einsums, causal over absolute positions ``start_pos`` and masked
    to ``kv_lens``, rows with no live key 0."""
    B, S, H, _ = q_nope.shape
    T = c_all.shape[1]
    scale = cfg.qk_head_dim ** -0.5
    c32 = c_all.float()
    q_lat = torch.einsum("bshd,hdr->bshr", q_nope.float(), w_uk.float())
    s = (torch.einsum("bshr,btr->bhst", q_lat, c32)
         + torch.einsum("bshd,btd->bhst", q_pe.float(), pe_all.float())) * scale
    dev = q_nope.device
    k_pos = torch.arange(T, dtype=torch.int32, device=dev)
    q_pos = start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]
    if kv_lens is not None:
        mask = mask & (k_pos[None, None, :] < kv_lens.to(dev)[:, None, None])
    s = torch.where(mask[:, None], s, torch.full_like(s, -float("inf")))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    o_lat = torch.einsum("bhst,btr->bshr", p, c32)
    o = torch.einsum("bshr,hrd->bshd", o_lat, w_uv.float())
    return o.reshape(B, S, H * cfg.v_head_dim).to(q_nope.dtype)


def _split_kv_b(w_kv_b, cfg: MLAConfig, dtype):
    """``kv_b [r, H·(dn + dv)]`` → ``(w_uk [H, dn, r], w_uv [H, r, dv])``."""
    H, dn = cfg.num_heads, cfg.qk_nope_head_dim
    w = _asarray(w_kv_b, dtype).reshape(cfg.kv_lora_rank, H, dn + cfg.v_head_dim)
    return w[:, :, :dn].permute(1, 2, 0), w[:, :, dn:].permute(1, 0, 2)


def _mla_attn_cached(h, lp, cfg: MLAConfig, cos, sin, cache, li, start_pos, kv_lens):
    """Write this call's latents into layer ``li`` of the cache at each row's
    ``start_pos`` (in place; clip-then-cast into a narrower arena) and
    attend over the whole layer in latent space."""
    q_nope, q_pe = _rope_q(_project_q(h, lp, cfg), cos, sin, cfg)
    c_new, pe_new = _latent_parts(_dot(h, lp["w_kv_a"]), lp["norm_kv"], cos, sin, cfg)
    B, S = c_new.shape[:2]
    dev = h.device
    bidx = torch.arange(B, device=dev)[:, None]
    pos = start_pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    dtype = h.dtype
    rows = []
    for arena, new, scale in ((cache.k, c_new, cache.k_scale[li]),
                              (cache.v, pe_new, cache.v_scale[li])):
        layer = arena[li]
        narrow = arena.dtype != new.dtype
        layer[bidx, pos, 0] = quantize_kv(new, scale, arena.dtype) if narrow else new
        row = layer[:, :, 0, :].to(dtype)
        rows.append(row * scale.to(dtype) if narrow else row)
    w_uk, w_uv = _split_kv_b(lp["w_kv_b"], cfg, dtype)
    return _mla_attend_latent(q_nope, q_pe, rows[0], rows[1], w_uk, w_uv, cfg, start_pos,
                              kv_lens)


# --------------------------------------------------------------------------
# MoE block (DeepSeek gate)
# --------------------------------------------------------------------------


def deepseek_gate(h: torch.Tensor, w_router: torch.Tensor, cfg: MLAConfig):
    """HF ``DeepseekV2MoEGate`` (JAX ``_deepseek_gate``): a float32 softmax
    over all experts, the top-k (restricted to the best ``topk_group`` of
    ``n_group`` groups under ``group_limited_greedy``, each group scored by
    its largest probability), no renormalization, times
    ``routed_scaling_factor``. Ties go to the lower index, as
    ``jax.lax.top_k``. Returns ``(probs [T, E], topv [T, K], topi [T, K])``."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(h.float() @ w_router.float(), dim=-1)
    if cfg.topk_method == "group_limited_greedy":
        T, G = probs.shape[0], cfg.n_group
        grp = probs.reshape(T, G, E // G)
        _, gidx = top_k(grp.amax(dim=-1), cfg.topk_group)
        gmask = (gidx[..., None] == torch.arange(G, device=h.device)).float().sum(dim=1)
        topv, topi = top_k((grp * gmask[:, :, None]).reshape(T, E), K)
    else:
        topv, topi = top_k(probs, K)
    return probs, topv * cfg.routed_scaling_factor, topi


def _deepseek_moe(h, lp, cfg: MLAConfig, token_mask, lossless, seg=_call):
    """Routed experts plus the always-on shared experts (HF
    ``DeepseekV2MoE``); returns ``(y [T, D], aux)``."""
    probs, topv, topi = deepseek_gate(h, lp["w_router"], cfg)
    aux = load_balance_loss(probs, topi, cfg.num_experts, token_mask)
    y = dispatch_experts(h, topi, topv, lp["w_gate_up"], lp["w_down"], cfg.num_experts,
                         moe_group_size=cfg.moe_group_size, capacity_factor=cfg.capacity_factor,
                         token_mask=token_mask, lossless=lossless, seg=seg)
    shared = _dot(seg(_swiglu, _dot(h, lp["w_shared_gate_up"])), lp["w_shared_down"])
    return y + shared, aux


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _rope_tables(cfg: MLAConfig, positions: torch.Tensor):
    """cos/sin of the rotary slice (``qk_rope_head_dim``) at ``positions``;
    the inverse frequencies are built once per device (no host copy in a
    captured step)."""
    scaling = json.dumps(cfg.rope_scaling, sort_keys=True) if cfg.rope_scaling else None
    inv_freq = _inv_freq(cfg.qk_rope_head_dim, cfg.rope_theta, scaling, positions.device)
    return rope_cos_sin(positions, inv_freq, cfg.rope_scaling)


def mla_forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: MLAConfig, *,
                cache=None, start_pos=0, kv_lens: Optional[torch.Tensor] = None,
                attn_impl: str = "auto", unroll: int = 1, compute_dtype=torch.bfloat16,
                remat=False, dropout_p: float = 0.0, dropout_seed: int = 0,
                token_mask: Optional[torch.Tensor] = None, return_router_aux: bool = False):
    """``tokens [B, S] -> (logits [B, S, V] float32, cache[, aux])`` (JAX's
    convention). Without a cache the expanded attention (training, parity);
    with one the latent cache, written in place at ``start_pos`` and masked
    to ``kv_lens``, and lossless expert dispatch. Training knobs: ``remat``
    none/full/dots, ``dropout_p`` with layer li's seed ``dropout_seed +
    li·7919`` (li counts the dense layers, then the MoE layers),
    ``token_mask [B, S]``; ``return_router_aux`` adds the mean of the MoE
    layers' load-balancing losses."""
    mode = training_knobs(cache, attn_impl, remat, unroll, dropout_p)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    B, S = tokens.shape
    D, eps = cfg.hidden_size, cfg.rms_eps
    x = params["embed"][tokens.long()].to(compute_dtype)
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    positions = start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = _rope_tables(cfg, positions)
    mask = None if token_mask is None else token_mask.to(dev).reshape(B * S)
    seg = _ckpt if mode == "dots" else _call

    def layer(x, lp, dense, li):
        h = seg(rmsnorm, x, lp["norm_attn"], eps)
        if cache is None:
            attn = _mla_attn_expanded(h, lp, cfg, cos, sin, kv_lens, dropout_p,
                                      dropout_seed + li * DROPOUT_LAYER_STRIDE, seg)
        else:
            attn = _mla_attn_cached(h, lp, cfg, cos, sin, cache, li, start_pos, kv_lens)
        x = x + _dot(attn, lp["wo"])
        h = seg(rmsnorm, x, lp["norm_mlp"], eps)
        if dense:
            y = _dot(seg(_swiglu, _dot(h, lp["w_gate_up"])), lp["w_down"])
            aux = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            y, aux = _deepseek_moe(h.reshape(B * S, D), lp, cfg, mask, cache is not None, seg)
            y = y.reshape(B, S, D)
        return x + y, aux

    auxes = []
    li = 0
    for gname, dense in (("dense_layers", True), ("moe_layers", False)):
        for lp in unstack_layers(params[gname]):
            if mode == "full":
                x, aux = _ckpt(lambda x, lp=lp, dense=dense, li=li: layer(x, lp, dense, li), x)
            else:
                x, aux = layer(x, lp, dense, li)
            if not dense:
                auxes.append(aux)
            li += 1
    new_cache = None if cache is None else dataclasses.replace(
        cache, lens=torch.maximum(cache.lens, start_pos + S))
    logits = _lm_head(params, rmsnorm(x, params["final_norm"], eps), cfg)
    if return_router_aux:
        aux = (torch.stack(auxes).mean() if auxes
               else torch.full((), float("nan"), device=dev))
        return logits, new_cache, aux
    return logits, new_cache
