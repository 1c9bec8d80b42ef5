"""Mixtral-family sparse Mixture-of-Experts decoder (counterpart of
``llm_fp8_tpu/models/moe.py``; the registry is a copy): Llama attention (with
Qwen3-MoE's per-head QK-norm) and top-k routed SwiGLU experts in place of
the MLP, numerics as HF ``MixtralForCausalLM``/``Qwen3MoeForCausalLM``.

Routing as JAX computes it: the router product and its softmax over all
experts in float32, the top-k of the probabilities, renormalized to sum to 1
(``norm_topk_prob``), then GShard's one-hot dispatch within groups of
``moe_group_size`` tokens with a static capacity per expert (a token's first
choice wins capacity over another token's second; overflow assignments get
a zero combine weight). Every shape is static: one-hot comparisons, a
cumsum and batched products, no ``nonzero`` and no data-dependent shape, so
a decode step runs inside a CUDA graph. A call with a KV cache (serving)
runs lossless (capacity = group size), as in JAX.

Ties in the top-k: ``jax.lax.top_k`` puts the lower expert index first
among equal probabilities; ``torch.topk`` promises no order, so
:func:`top_k` takes a stable descending sort (the slot order sets the
capacity priority).

The expert products (JAX's ``_edot`` einsums, which XLA compiles) are
batched bf16 products with a float32 output (:func:`bmm_f32`: one cuBLAS
``bmm`` with ``out_dtype=float32`` on the card, a float32 product of the
bf16 values on the CPU), the per-channel scale applied after in float32, as
the JAX einsum with ``preferred_element_type=float32`` rounds once. The
router, dispatch and combine are plain torch, as they are plain XLA in JAX.
Attention is the Llama family's: K3 on the card for every prefill, verify
block and training forward (K6 in the backward), the plain
``decode_attention`` for one query.

``moe_forward`` keeps JAX's return convention: ``(logits, cache)``, and
``(logits, cache, mean router aux)`` under ``return_router_aux`` (the
``Trainer`` scales it by ``router_aux_coef``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rmsnorm import rmsnorm
from ..ops.rotary import apply_rope
from ..quant import QTensor, RecipeSet, quantize, quantize_mx
from ..quant.dot import serving_layout
from ..utils.backend import resolve_device
from .config import ModelConfig
from .llama import _call, _dot, _lm_head, _rope_tables, _swiglu
from .zoo import run_layers, state_getter, training_knobs

__all__ = ["MoEConfig", "MOE_REGISTRY", "init_moe_params", "moe_forward",
           "pack_mixtral_state_dict", "export_mixtral_state_dict",
           "pack_qwen3_moe_state_dict", "export_qwen3_moe_state_dict",
           "quantize_moe_params", "load_balance_loss", "dispatch_experts", "route", "top_k",
           "bmm_f32", "expert_capacity"]


@dataclasses.dataclass(frozen=True)
class MoEConfig(ModelConfig):
    """Mixtral = Llama attention + routed experts in place of the MLP."""

    num_experts: int = 8
    num_experts_per_tok: int = 2
    #: Within a routing group an expert takes at most ``ceil(g·k/E) ·
    #: capacity_factor`` tokens; overflow assignments are dropped. ``<= 0``:
    #: full capacity (lossless). A call with a KV cache always runs lossless.
    capacity_factor: float = 2.0
    #: GShard routing group: dispatch tensors are ``[g, E, C]`` a group.
    moe_group_size: int = 512
    router_aux_coef: float = 0.02
    #: Renormalize the top-k gate weights (Mixtral always; Qwen3-MoE's flag).
    norm_topk_prob: bool = True

    def num_params(self) -> int:
        d, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = (d * self.qkv_dim + self.q_dim * d + d * self.num_experts
                     + self.num_experts * 3 * d * i + 2 * d)
        embed = v * d * (1 if self.tie_word_embeddings else 2)
        return self.num_layers * per_layer + embed + d


MOE_REGISTRY: Dict[str, MoEConfig] = {
    # mistralai/Mixtral-8x7B-v0.1 config.json.
    "mixtral-8x7b": MoEConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=1e6, rms_eps=1e-5,
        max_position_embeddings=32768, num_experts=8, num_experts_per_tok=2,
    ),
    "debug-mixtral": MoEConfig(
        name="debug-mixtral", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, rope_theta=1e6, rms_eps=1e-5,
        max_position_embeddings=2048, num_experts=4, num_experts_per_tok=2,
    ),
    # Qwen/Qwen3-30B-A3B config.json: every layer sparse, intermediate_size
    # is the expert width (moe_intermediate_size).
    "qwen3-30b-a3b": MoEConfig(
        name="qwen3-30b-a3b", vocab_size=151936, hidden_size=2048,
        intermediate_size=768, num_layers=48, num_heads=32, num_kv_heads=4,
        head_dim=128, rope_theta=1e6, rms_eps=1e-6, qk_norm=True,
        max_position_embeddings=40960, num_experts=128,
        num_experts_per_tok=8,
    ),
    "debug-qwen3moe": MoEConfig(
        name="debug-qwen3moe", vocab_size=512, hidden_size=128,
        intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=32, rope_theta=1e6, rms_eps=1e-6, qk_norm=True,
        max_position_embeddings=2048, num_experts=4, num_experts_per_tok=2,
    ),
}


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------


def init_moe_params(cfg: MoEConfig, generator: Optional[torch.Generator] = None, *,
                    dtype=torch.bfloat16, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02), drawn on ``device`` from ``generator``
    (a new one seeded with ``seed`` when none is given); norms 1."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, V, L, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                     cfg.num_layers, cfg.num_experts)

    def w(*shape):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {"wqkv": w(L, D, cfg.qkv_dim), "wo": w(L, cfg.q_dim, D),
              "w_router": w(L, D, E), "w_gate_up": w(L, E, D, 2 * I),
              "w_down": w(L, E, I, D), "norm_attn": ones(L, D), "norm_mlp": ones(L, D)}
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, cfg.head_dim)
        layers["k_norm"] = ones(L, cfg.head_dim)
    params = {"embed": w(V, D), "layers": layers, "final_norm": ones(D)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(D, V)
    return params


#: HF names of each family: the block prefix, the router, the experts'
#: (gate, up, down) Linears.
_HF_NAMES = {
    "mixtral": ("block_sparse_moe.", "gate", ("w1", "w3", "w2")),
    "qwen3_moe": ("mlp.", "gate", ("gate_proj", "up_proj", "down_proj")),
}


def _pack(sd, cfg: MoEConfig, family: str, dtype, device) -> Dict[str, Any]:
    """HF state dict → stacked params: q/k/v fused into ``wqkv``, each expert's
    gate|up into ``w_gate_up [E, D, 2I]``, Linears transposed, experts
    stacked along a leading E axis. A missing tensor raises ``KeyError``."""
    get = state_getter(sd, dtype, device)
    block, router, (gate, up, down) = _HF_NAMES[family]

    def g(name):
        if name not in sd:
            raise KeyError(f"missing {name!r} in checkpoint")
        return get(name)

    keys = ["wqkv", "wo", "w_router", "w_gate_up", "w_down", "norm_attn", "norm_mlp"]
    if family == "qwen3_moe":
        keys += ["q_norm", "k_norm"]
    cols = {k: [] for k in keys}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        cols["wqkv"].append(torch.cat([g(p + f"self_attn.{n}_proj.weight").t() for n in "qkv"],
                                      dim=1))
        cols["wo"].append(g(p + "self_attn.o_proj.weight").t())
        if family == "qwen3_moe":
            cols["q_norm"].append(g(p + "self_attn.q_norm.weight"))
            cols["k_norm"].append(g(p + "self_attn.k_norm.weight"))
        cols["w_router"].append(g(p + block + router + ".weight").t())
        ep = [p + block + f"experts.{e}." for e in range(cfg.num_experts)]
        cols["w_gate_up"].append(torch.stack([
            torch.cat([g(x + gate + ".weight").t(), g(x + up + ".weight").t()], dim=1)
            for x in ep]))
        cols["w_down"].append(torch.stack([g(x + down + ".weight").t() for x in ep]))
        cols["norm_attn"].append(g(p + "input_layernorm.weight"))
        cols["norm_mlp"].append(g(p + "post_attention_layernorm.weight"))
    params = {"embed": g("model.embed_tokens.weight"),
              "layers": {k: torch.stack(v) for k, v in cols.items()},
              "final_norm": g("model.norm.weight")}
    if not cfg.tie_word_embeddings and "lm_head.weight" in sd:
        params["lm_head"] = g("lm_head.weight").t()
    return params


def pack_mixtral_state_dict(sd, cfg: MoEConfig, dtype=torch.bfloat16, device=None):
    """HF ``MixtralForCausalLM`` state dict → stacked params (router at
    ``block_sparse_moe.gate``, experts' ``w1``/``w3``/``w2``)."""
    return _pack(sd, cfg, "mixtral", dtype, device)


def pack_qwen3_moe_state_dict(sd, cfg: MoEConfig, dtype=torch.bfloat16, device=None):
    """HF ``Qwen3MoeForCausalLM`` state dict → stacked params (per-head
    ``q_norm``/``k_norm``, router at ``mlp.gate``, experts'
    ``gate_proj``/``up_proj``/``down_proj``)."""
    return _pack(sd, cfg, "qwen3_moe", dtype, device)


def _export(params, cfg: MoEConfig, family: str) -> Dict[str, np.ndarray]:
    """Inverse of :func:`_pack`: stacked params → HF names, float32 numpy
    arrays. Quantized leaves must be dequantized by the caller."""
    block, router, (gate, up, down) = _HF_NAMES[family]
    lp = params["layers"]
    out: Dict[str, np.ndarray] = {}

    def put(name, t):
        out[name] = t.detach().float().cpu().contiguous().numpy()

    put("model.embed_tokens.weight", params["embed"])
    put("model.norm.weight", params["final_norm"])
    if "lm_head" in params:
        put("lm_head.weight", params["lm_head"].t())
    qd, kvd, inter = cfg.q_dim, cfg.kv_dim, cfg.intermediate_size
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        wqkv = lp["wqkv"][i]
        put(p + "self_attn.q_proj.weight", wqkv[:, :qd].t())
        put(p + "self_attn.k_proj.weight", wqkv[:, qd:qd + kvd].t())
        put(p + "self_attn.v_proj.weight", wqkv[:, qd + kvd:].t())
        put(p + "self_attn.o_proj.weight", lp["wo"][i].t())
        if family == "qwen3_moe":
            put(p + "self_attn.q_norm.weight", lp["q_norm"][i])
            put(p + "self_attn.k_norm.weight", lp["k_norm"][i])
        put(p + block + router + ".weight", lp["w_router"][i].t())
        for e in range(cfg.num_experts):
            ep = p + block + f"experts.{e}."
            gu = lp["w_gate_up"][i, e]
            put(ep + gate + ".weight", gu[:, :inter].t())
            put(ep + up + ".weight", gu[:, inter:].t())
            put(ep + down + ".weight", lp["w_down"][i, e].t())
        put(p + "input_layernorm.weight", lp["norm_attn"][i])
        put(p + "post_attention_layernorm.weight", lp["norm_mlp"][i])
    return out


def export_mixtral_state_dict(params: Dict[str, Any], cfg: MoEConfig) -> Dict[str, np.ndarray]:
    """Stacked MoE params → HF Mixtral names (the inverse of the packer)."""
    return _export(params, cfg, "mixtral")


def export_qwen3_moe_state_dict(params: Dict[str, Any], cfg: MoEConfig
                                ) -> Dict[str, np.ndarray]:
    """Stacked Qwen3-MoE params → HF names (the inverse of the packer)."""
    return _export(params, cfg, "qwen3_moe")


def quantize_moe_params(params: Dict[str, Any], recipes: RecipeSet) -> Dict[str, Any]:
    """Prequantize for serving (JAX ``quantize_moe_params``): per-output-channel
    scales along each weight's contraction (MX blocks along it for the block
    recipe), subnormal codes flushed. ``wqkv`` and ``wo`` (axis 1) have their
    codes laid out for the ``qdot`` route in force, as the Llama family's
    ``quantize_params`` lays them out; the experts' ``w_gate_up [L, E, D,
    2I]`` and ``w_down [L, E, I, D]`` (axis 2) stay in JAX's row-major layout,
    which the expert products read as it is; the router stays high
    precision; ``lm_head`` is quantized only where its role has a recipe."""
    out = dict(params)
    layers = dict(params["layers"])
    for name, role, axis in (("wqkv", "attn_qkv", 1), ("wo", "attn_out", 1),
                             ("w_gate_up", "mlp", 2), ("w_down", "mlp", 2)):
        recipe = recipes.for_role(role)
        if recipe is None:
            continue
        wv = layers[name].float()
        if recipe.granularity == "block32":
            layers[name] = quantize_mx(wv, recipe.fmt_fwd, block_axis=axis, flush_subnormal=True)
        else:
            q = quantize(wv, recipe.fmt_fwd, axes=(axis,), margin=recipe.margin,
                         group_size=recipe.group_size, flush_subnormal=True)
            layers[name] = serving_layout(q) if axis == 1 else q
        del wv
    out["layers"] = layers
    lm_recipe = recipes.for_role("lm_head")
    if lm_recipe is not None and "lm_head" in out:
        out["lm_head"] = serving_layout(quantize(out["lm_head"].float(), lm_recipe.fmt_fwd,
                                                 axes=(0,), flush_subnormal=True))
    return out


# --------------------------------------------------------------------------
# Routed MLP
# --------------------------------------------------------------------------


class _BmmF32(torch.autograd.Function):
    """The batched ``_MatmulF32`` (``quant/dot.py``): ``torch.bmm(...,
    out_dtype=float32)`` has no autograd formula; this gives it JAX's
    transpose of a ``preferred_element_type=float32`` einsum, gradients in
    the operands' dtypes (on the card the float32 output gradient is rounded
    to the operands' dtype for the two products)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if g.is_cuda:
            gl = g.to(a.dtype)
            return (torch.bmm(gl, b.transpose(1, 2)).to(a.dtype),
                    torch.bmm(a.transpose(1, 2), gl).to(b.dtype))
        return (torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype),
                torch.bmm(a.float().transpose(1, 2), g).to(b.dtype))


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [E, M, K] @ b [E, K, N]`` with a float32 output: float32 operands
    multiply as they are; bf16 ones as one ``bmm`` with a float32 output on
    the card and a float32 product of the bf16 values on the CPU (JAX's
    einsum with ``preferred_element_type=float32``). Differentiable."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


def expert_weight(w, dtype) -> torch.Tensor:
    """The expert codes as ``dtype`` values for the product: MX blocks
    dequantized (their scales vary along the contraction), channel-scaled
    codes converted as they are (the scale comes after the product), plain
    weights cast."""
    if isinstance(w, QTensor):
        return w.dequantize(dtype) if w.block_size is not None else w.unpack().to(dtype)
    return w.to(dtype)


def _edot(x: torch.Tensor, w) -> torch.Tensor:
    """``x [E, C, K] @ w [E, K, N]`` where ``w`` may be a QTensor (JAX
    ``_edot``): the product in x's dtype with a float32 output, a channel
    scale ``[E, 1, N]`` applied after it in float32, then x's dtype."""
    y = bmm_f32(x, expert_weight(w, x.dtype))
    if isinstance(w, QTensor) and w.block_size is None:
        y = y * w.scale.float()
    return y.to(x.dtype)


def top_k(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row, the
    lower index first among equal values (``jax.lax.top_k``'s order): a
    stable descending sort, cut to ``k``."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(h: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """The router (HF ``MixtralSparseMoeBlock``): ``h [T, D]`` times the
    router in float32, a float32 softmax over all experts, the top-k
    (renormalized to sum 1 under ``norm_topk_prob``). Returns ``(probs [T,
    E], topv [T, K], topi [T, K])``."""
    probs = torch.softmax(h.float() @ w_router.float(), dim=-1)
    topv, topi = top_k(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    return probs, topv, topi


def load_balance_loss(probs: torch.Tensor, topi: torch.Tensor, num_experts: int,
                      token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch/Mixtral auxiliary loss ``E · Σ_{k,e} f_{k,e} · P_e`` (HF
    ``load_balancing_loss_func``): ``f`` the per-slot mean of the one-hot
    selections (not divided by K: uniform routing gives K), ``P`` the mean
    router probability, padding (``token_mask`` 0) masked out of both."""
    sel = (topi[..., None] == torch.arange(num_experts, device=topi.device)).float()
    p32 = probs.float()
    if token_mask is None:
        f, p = sel.mean(dim=0), p32.mean(dim=0)
    else:
        m = token_mask.to(p32.device).float()
        denom = torch.clamp(m.sum(), min=1.0)
        f = (sel * m[:, None, None]).sum(dim=0) / denom
        p = (p32 * m[:, None]).sum(dim=0) / denom
    return num_experts * (f * p[None, :]).sum()


def expert_capacity(g: int, k: int, num_experts: int, capacity_factor: float,
                    lossless: bool) -> int:
    """Slots an expert has in a group of ``g`` tokens: ``g`` when lossless or
    ``capacity_factor <= 0`` (top-k picks are distinct, so an expert sees at
    most ``g``), else ``min(g, max(1, int(ceil(g·k/E) · capacity_factor)))``."""
    if lossless or capacity_factor <= 0:
        return g
    return min(g, max(1, int(-(-g * k // num_experts) * capacity_factor)))


def dispatch_experts(h: torch.Tensor, topi: torch.Tensor, topv: torch.Tensor, w_gate_up,
                     w_down, num_experts: int, *, moe_group_size: int = 512,
                     capacity_factor: float = 2.0, token_mask: Optional[torch.Tensor] = None,
                     lossless: bool = False, seg=_call) -> torch.Tensor:
    """Routed SwiGLU experts through GShard's grouped one-hot dispatch (JAX
    ``dispatch_experts``): ``h [T, D]``, ``topi``/``topv [T, K]``, the
    experts' ``w_gate_up [E, D, 2I]`` and ``w_down [E, I, D]`` (tensors or
    QTensors). Tokens route within groups of ``moe_group_size`` (T padded
    with masked rows); padding (``token_mask`` 0) claims no capacity. The
    dispatch tensor ``[G, g, E, C]`` is one batched product that contracts
    the K slots (no ``[G, g, K, E, C]`` intermediate), the combine tensor the
    dispatch times each (token, expert)'s gate weight (exact whatever the
    card's float32 matmul precision); the combine sums in float32. ``seg``
    runs the SwiGLU (a checkpointed segment under remat ``dots``). Returns
    ``y [T, D]``."""
    T, D = h.shape
    E, K = num_experts, topi.shape[-1]
    dev = h.device
    g = min(T, max(1, moe_group_size))
    Tp = -(-T // g) * g
    valid = (torch.ones((T,), dtype=torch.float32, device=dev) if token_mask is None
             else token_mask.to(dev).float())
    if Tp != T:
        pad = Tp - T
        h, topi, topv = F.pad(h, (0, 0, 0, pad)), F.pad(topi, (0, 0, 0, pad)), \
            F.pad(topv, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    G = Tp // g
    C = expert_capacity(g, K, E, capacity_factor, lossless)

    # Masked selections never claim a slot.
    selg = ((topi[..., None] == torch.arange(E, device=dev)).to(torch.int32)
            * valid[:, None, None].to(torch.int32)).reshape(G, g, K, E)
    # Position in the expert, slot-major within the group: every token's
    # first choice before any token's second.
    flat = selg.transpose(1, 2).reshape(G, K * g, E)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) - 1).reshape(G, K, g, E).transpose(1, 2)
    pos_tk = (pos * selg).sum(dim=-1)                              # [G, g, K]
    keep = ((pos_tk < C) & (selg.sum(dim=-1) > 0)).float()
    slot = (pos_tk[..., None] == torch.arange(C, device=dev)).float()   # [G, g, K, C]
    sel32 = selg.float() * keep[..., None]                        # [G, g, K, E]
    dispatch = torch.bmm(sel32.reshape(G * g, K, E).transpose(1, 2),
                         slot.reshape(G * g, K, C)).reshape(G, g, E, C)
    # The kept slot's gate weight at (token, expert): at most one k each.
    gate_w = (sel32 * topv.reshape(G, g, K, 1).float()).sum(dim=2)    # [G, g, E]
    combine = dispatch * gate_w[..., None]

    xe = torch.bmm(dispatch.to(h.dtype).reshape(G, g, E * C).transpose(1, 2),
                   h.reshape(G, g, D))                            # [G, E·C, D]
    # All groups' rows of an expert side by side: one product an expert.
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    h1 = seg(_swiglu, _edot(xe, w_gate_up))
    ye = _edot(h1, w_down)                                        # [E, G·C, D]
    yg = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    y = torch.bmm(combine.reshape(G, g, E * C), yg.float()).to(h.dtype)
    return y.reshape(Tp, D)[:T]


def _moe_mlp(h, w_router, w_gate_up, w_down, cfg: MoEConfig, *,
             token_mask: Optional[torch.Tensor] = None, lossless: bool = False, seg=_call):
    """Routing (:func:`route`) over :func:`dispatch_experts`; returns ``(y
    [T, D], aux)``."""
    probs, topv, topi = route(h, w_router, cfg)
    aux = load_balance_loss(probs, topi, cfg.num_experts, token_mask)
    y = dispatch_experts(h, topi, topv, w_gate_up, w_down, cfg.num_experts,
                         moe_group_size=cfg.moe_group_size,
                         capacity_factor=cfg.capacity_factor, token_mask=token_mask,
                         lossless=lossless, seg=seg)
    return y, aux


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def moe_forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: MoEConfig, *,
                cache=None, start_pos=0, kv_lens: Optional[torch.Tensor] = None,
                attn_impl: str = "auto", unroll: int = 1, compute_dtype=torch.bfloat16,
                remat=False, dropout_p: float = 0.0, dropout_seed: int = 0,
                token_mask: Optional[torch.Tensor] = None, return_router_aux: bool = False):
    """``tokens [B, S] -> (logits [B, S, V] float32, cache[, aux])`` (JAX's
    convention, with or without a cache): rotary at ``start_pos`` (after
    Qwen3-MoE's per-head QK-norm), K/V written per sequence in place,
    ``kv_lens`` masking. With a cache the experts run lossless. Training
    knobs: ``remat`` none/full/dots, ``dropout_p`` with layer li's seed
    ``dropout_seed + li·7919``, ``token_mask [B, S]`` (padding claims no
    capacity and stays out of the aux statistics); ``return_router_aux``
    adds the mean of the layers' load-balancing losses."""
    mode = training_knobs(cache, attn_impl, remat, unroll, dropout_p)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    B, S = tokens.shape
    D, Hq, Hk, Dh, eps = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.rms_eps
    x = params["embed"][tokens.long()].to(compute_dtype)
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    positions = start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = _rope_tables(cfg, positions)
    mask = None if token_mask is None else token_mask.to(dev).reshape(B * S)

    def heads(qkv, *qk_norms):
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        q, k = q.reshape(B, S, Hq, Dh), k.reshape(B, S, Hk, Dh)
        if qk_norms:  # Qwen3-MoE: per-head QK-norm before rope
            q, k = rmsnorm(q, qk_norms[0], eps), rmsnorm(k, qk_norms[1], eps)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.reshape(B, S, Hk, Dh)

    def layer(x, lp, attend, seg):
        h = seg(rmsnorm, x, lp["norm_attn"], eps)
        norms = (lp["q_norm"], lp["k_norm"]) if "q_norm" in lp else ()
        attn = attend(*seg(heads, _dot(h, lp["wqkv"]), *norms))
        x = x + _dot(attn.reshape(B, S, Hq * Dh), lp["wo"])
        h = seg(rmsnorm, x, lp["norm_mlp"], eps)
        y, aux = _moe_mlp(h.reshape(B * S, D), lp["w_router"], lp["w_gate_up"], lp["w_down"],
                          cfg, token_mask=mask, lossless=cache is not None, seg=seg)
        return x + y.reshape(B, S, D), aux

    x, new_cache, auxes = run_layers(params, x, layer, cache=cache, start_pos=start_pos,
                                     kv_lens=kv_lens, remat=mode, dropout_p=dropout_p,
                                     dropout_seed=dropout_seed, with_aux=True)
    logits = _lm_head(params, rmsnorm(x, params["final_norm"], eps), cfg)
    if return_router_aux:
        return logits, new_cache, torch.stack(auxes).mean()
    return logits, new_cache
