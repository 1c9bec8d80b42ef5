"""Llama/Qwen decoder (counterpart of ``llm_fp8_tpu/models/llama.py``).

Parameters are a plain dict of tensors with the JAX package's stacked layout
(every layer parameter has a leading ``[num_layers]`` axis, fused ``wqkv =
[q|k|v]`` and ``w_gate_up = [gate|up]``); weights are tensors or
:class:`QTensor`. Where JAX scans over the layers, this is a Python loop;
where JAX donates cache buffers, the caches here are updated in place.

Quantized projections run ``quant.qdot`` (on the card: K9 and fp8 products
for fp8 weights where the card has them, K1 for the others), the arena
decode attention K2, the paged decode attention K5 and the prefill
attention K3 on the card.
Plain bf16 products (unquantized weights, the tied lm_head) are cuBLAS calls
(``torch.matmul``/``torch.mm``) on the card, as the JAX package leaves them
to XLA; on the CPU they are float32 products of the bf16 operands, as XLA
computes them there.

Training: :func:`forward` differentiates into float32 parameters (the bf16
recipe), and :func:`forward_fp8_train` runs the four GEMM sites of every
layer through ``quant.fp8_dot`` (attention through K3 forward and K6
backward on the card). Both take attention dropout (``dropout_p``, with the
per-layer seed ``dropout_seed + layer·7919``, K3/K6's counter hash) and
per-layer rematerialization (``remat``): ``"full"`` checkpoints each layer
whole (``torch.utils.checkpoint``, non-reentrant: the backward re-runs the
layer's forward, K3 included); ``"dots"`` checkpoints only the elementwise
segments between the GEMM sites and K3 (the norms, the bias, split and
rotary of q/k/v, SwiGLU), so the GEMM outputs and K3's residuals are kept
and the backward recomputes only those segments: JAX's ``dots`` policy with
its ``flash_res`` names. A layer's amaxes are the first forward's (the
recompute's are dropped); the fp8 dots keep their quantized residuals on
their autograd context either way.

ALiBi models (``cfg.alibi``: Baichuan-13B) have no rotary: their slopes
(:func:`~..ops.attention.default_alibi_slopes`, built once per head count
and device) go to K3, K2, K5 and the plain attention.

Tensor parallelism (serving): :func:`forward` and
:func:`forward_decode_arena` take ``tp``, a :class:`~..parallel.tensor.TPRank`,
with the rank's shard (``parallel/tensor.py::tp_rank_params``) and config
(its head counts and intermediate dim). The outputs of ``wo`` and
``w_down`` are float32 partials, all-reduced over the group and cast once
(a sum of bf16 partials would round once a rank where the single product
rounds once); their fp8native inputs are quantized with each row's amax
over the group (``quant/dot.py::k_split_over``). K1 plans a split
column-parallel product (``wqkv``, ``w_gate_up``, ``lm_head``) as the whole
product (``kernels/quant_matmul.py::planned_as_whole``), so the rank's
columns sum as the mesh-less run's do. The embedding looks up
the rank's vocabulary rows, zeros elsewhere, and all-reduces (exact: one
rank holds each id); the logits are all-gathered along the vocabulary
(exact). A rank's ALiBi slopes are its heads' slice of the whole model's.
Parts the layout replicates run whole, with no collective. Without ``tp``
nothing of this runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attention import decode_attention_arena
from ..kernels.paged_attention import paged_attention
from ..ops.attention import attention, default_alibi_slopes
from ..ops.rmsnorm import rmsnorm
from ..ops.rotary import apply_rope, rope_cos_sin, rope_frequencies
from ..quant import DotAmaxes, QTensor, RecipeSet, fp8_dot, qdot, quantize, quantize_mx
from ..quant.dot import matmul_f32, serving_layout
from ..utils.backend import resolve_device
from .config import ModelConfig

__all__ = ["init_params", "quantize_params", "KVCache", "init_kv_cache",
           "cache_append_attend", "forward", "forward_decode_arena", "forward_paged",
           "unstack_layers", "DOT_SITES", "SITE_ROLE", "forward_fp8_train", "lm_head_weight",
           "remat_mode", "DROPOUT_LAYER_STRIDE"]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                dtype=torch.bfloat16, device=None, seed: int = 0) -> Dict[str, Any]:
    """Random init, normal(0, 0.02), drawn on ``device`` from ``generator``
    (a new one seeded with ``seed`` when none is given)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    D, I, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers

    def w(*shape):
        t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (t * 0.02).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "wqkv": w(L, D, cfg.qkv_dim),
        "wo": w(L, cfg.q_dim, D),
        "w_gate_up": w(L, D, 2 * I),
        "w_down": w(L, I, D),
        "norm_attn": ones(L, D),
        "norm_mlp": ones(L, D),
    }
    if cfg.qkv_bias:
        layers["bqkv"] = torch.zeros((L, cfg.qkv_dim), dtype=dtype, device=device)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, cfg.head_dim)
        layers["k_norm"] = ones(L, cfg.head_dim)
    params = {"embed": w(V, D), "layers": layers, "final_norm": ones(D)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(D, V)
    return params


def quantize_params(params: Dict[str, Any], recipes: RecipeSet) -> Dict[str, Any]:
    """Prequantize the projection weights per the recipe set: per-output-
    channel scales (MX blocks for the block recipe), subnormal codes flushed,
    codes laid out for the ``qdot`` route in force (``serving_layout``)."""
    out = dict(params)
    layers = dict(params["layers"])

    def q(name: str, role: str, contract_axis: int = 1):
        recipe = recipes.for_role(role)
        if recipe is None:
            return
        wv = layers[name].float()
        if recipe.granularity == "block32":
            layers[name] = quantize_mx(wv, recipe.fmt_fwd, block_axis=contract_axis,
                                       flush_subnormal=True)
        else:
            layers[name] = serving_layout(quantize(
                wv, recipe.fmt_fwd, axes=(contract_axis,), margin=recipe.margin,
                group_size=recipe.group_size, flush_subnormal=True))

    q("wqkv", "attn_qkv")
    q("wo", "attn_out")
    q("w_gate_up", "mlp")
    q("w_down", "mlp")
    out["layers"] = layers
    lm_recipe = recipes.for_role("lm_head")
    if lm_recipe is not None and "lm_head" in out:
        out["lm_head"] = serving_layout(quantize(out["lm_head"].float(), lm_recipe.fmt_fwd,
                                                 axes=(0,), flush_subnormal=True))
    return out


def unstack_layers(layers: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer's parameters (views), one ``unbind`` per stacked tensor.
    Under autograd the unbind's backward stacks the layer gradients once,
    where indexing layer by layer writes a zero-filled full-size gradient
    per layer and adds them up. Layers a parameter-sharded world gathers
    (``parallel/fsdp.py::ShardedLayers``) come a layer at a time, each
    gathered just before it runs."""
    if hasattr(layers, "unstack"):
        return layers.unstack()
    L = next(iter(layers.values())).shape[0]
    per = {k: ([v.layer(i) for i in range(L)] if isinstance(v, QTensor) else v.unbind(0))
           for k, v in layers.items()}
    return [{k: per[k][i] for k in layers} for i in range(L)]


def _dot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is a tensor or a QTensor (K1)."""
    if isinstance(w, QTensor):
        return qdot(x, w)
    if x.is_cuda:
        return torch.matmul(x, w.to(x.dtype))
    return (x.float() @ w.to(x.dtype).float()).to(x.dtype)


#: The four quantized-GEMM sites per decoder layer: QKV projection,
#: attention out-projection, MLP gate|up and MLP down.
DOT_SITES = ("attn_qkv", "attn_out", "mlp_gate_up", "mlp_down")

#: Dot site -> recipe-set role (both MLP matmuls share the "mlp" recipe).
SITE_ROLE = {
    "attn_qkv": "attn_qkv",
    "attn_out": "attn_out",
    "mlp_gate_up": "mlp",
    "mlp_down": "mlp",
}


def _make_train_dots(recipes: Optional[RecipeSet], scales, sinks):
    """Per-site closures ``(x, w) -> (y, DotAmaxes)`` for one layer of the
    FP8 training path. ``scales[site]`` = (x_scale, w_scale) delayed 0-d
    scales; ``sinks[site]`` = the zero scalar whose gradient carries the
    backward amax. High-precision sites report zero amaxes."""
    dots = {}
    for site in DOT_SITES:
        recipe = recipes.for_role(SITE_ROLE[site]) if recipes else None
        if recipe is None:

            def plain(x, w):
                z = torch.zeros((), dtype=torch.float32, device=x.device)
                return _dot(x, w), DotAmaxes(z, z, z)

            dots[site] = plain
        else:

            def quantized(x, w, recipe=recipe, site=site):
                x_s, w_s = scales[site]
                y, amaxes = fp8_dot(x.reshape(-1, x.shape[-1]), w, x_s, w_s, sinks[site],
                                    recipe)
                return y.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype), amaxes

            dots[site] = quantized
    return dots


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """Cache arena ``k/v [L, B, S_max, Hk, Dh]``, fills ``lens [B]`` and
    per-layer descales ``k_scale/v_scale [L]``. Updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    lens: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    """Zeroed cache arena for ``cfg``. A family whose K and V stores differ
    in shape (the MLA latent cache: K the compressed latent, V the rotary
    slice) gives ``cfg.kv_cache_dims() -> (Hk, Dk, Dv)``, as in JAX; the
    default is the symmetric per-head layout."""
    device = resolve_device(device)
    L = cfg.num_layers
    dims = getattr(cfg, "kv_cache_dims", None)
    Hk, Dk, Dv = dims() if dims else (cfg.num_kv_heads, cfg.head_dim, cfg.head_dim)
    return KVCache(
        k=torch.zeros((L, batch, max_len, Hk, Dk), dtype=dtype, device=device),
        v=torch.zeros((L, batch, max_len, Hk, Dv), dtype=dtype, device=device),
        lens=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=torch.ones((L,), dtype=torch.float32, device=device),
        v_scale=torch.ones((L,), dtype=torch.float32, device=device),
    )


def storage_max(dtype: torch.dtype) -> float:
    """Largest finite value of a KV storage dtype (the clip before the cast)."""
    return float(torch.iinfo(dtype).max if not dtype.is_floating_point
                 else torch.finfo(dtype).max)


def quantize_kv(t: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """K/V into a cache dtype: divide by the scale, clip into the storage
    range (e4m3fn has no inf), round (integers) and cast."""
    fmax = storage_max(dtype)
    q = torch.clamp(t.float() / scale, -fmax, fmax)
    return (torch.round(q) if not dtype.is_floating_point else q).to(dtype)


def cache_append_attend(q, kk, vv, cache_kv: Tuple, start_pos: torch.Tensor,
                        kv_lens: Optional[torch.Tensor], *,
                        scale: Optional[float] = None, window: Optional[int] = None,
                        softcap: Optional[float] = None, alibi_slopes=None):
    """Write the new K/V at each sequence's ``start_pos`` (quantizing when the
    cache is narrower) in place, then attend over the masked cache.

    ``cache_kv``: ``(k_cache, v_cache, k_scale, v_scale[, layer_idx])`` with
    per-layer arenas ``[B, S, Hk, Dh]`` or full ``[L, B, S, Hk, Dh]`` ones
    when ``layer_idx`` is given. Returns ``(attn, (k_cache, v_cache))``.
    """
    k_cache, v_cache, k_scale, v_scale = cache_kv[:4]
    layer_idx = cache_kv[4] if len(cache_kv) > 4 else None
    if k_cache.dtype != kk.dtype:
        k_store = quantize_kv(kk, k_scale, k_cache.dtype)
        v_store = quantize_kv(vv, v_scale, v_cache.dtype)
    else:
        k_store, v_store = kk, vv
    B, S = k_store.shape[:2]
    bidx = torch.arange(B, device=q.device)[:, None]
    pos = start_pos.long()[:, None] + torch.arange(S, device=q.device)[None, :]
    k_layer = k_cache if layer_idx is None else k_cache[layer_idx]
    v_layer = v_cache if layer_idx is None else v_cache[layer_idx]
    k_layer[bidx, pos] = k_store
    v_layer[bidx, pos] = v_store
    k_all, v_all = k_layer.to(q.dtype), v_layer.to(q.dtype)
    if k_layer.dtype != kk.dtype:
        k_all = k_all * torch.as_tensor(k_scale, device=q.device).to(q.dtype)
        v_all = v_all * torch.as_tensor(v_scale, device=q.device).to(q.dtype)
    attn = attention(q, k_all, v_all, causal=True, q_offset=start_pos, kv_lens=kv_lens,
                     scale=scale, window=window, softcap=softcap, alibi_slopes=alibi_slopes)
    return attn, (k_cache, v_cache)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, scaling: Optional[str], device: torch.device):
    """The rotary inverse frequencies on ``device``, built once per model
    shape and device (``scaling`` is the config's dict as sorted JSON): a
    decode step reads them without a host-to-device copy, as a captured
    CUDA graph must."""
    return rope_frequencies(head_dim, theta, scaling and json.loads(scaling)).to(device)


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """``(cos, sin)`` at ``positions``; ``(None, None)`` for an ALiBi model."""
    if cfg.alibi:
        return None, None
    scaling = json.dumps(cfg.rope_scaling, sort_keys=True) if cfg.rope_scaling else None
    inv_freq = _inv_freq(cfg.head_dim, cfg.rope_theta, scaling, positions.device)
    return rope_cos_sin(positions, inv_freq, cfg.rope_scaling)


def _alibi(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    """The ALiBi slopes ``[Hq]`` on ``device`` (built once), or None."""
    return default_alibi_slopes(cfg.num_heads, device) if cfg.alibi else None


def _rank_alibi(cfg: ModelConfig, device, tp) -> Optional[torch.Tensor]:
    """A tp rank's ALiBi slopes: with split heads, its heads' slice of the
    whole model's (slopes rebuilt for the rank's head count would be another
    model's); without ``tp`` or with the heads whole, :func:`_alibi`'s."""
    if tp is None or not cfg.alibi or not tp.layout.heads:
        return _alibi(cfg, device)
    h = cfg.num_heads
    return default_alibi_slopes(tp.num_heads, device)[tp.rank * h:(tp.rank + 1) * h]


def _embed(params, tokens: torch.Tensor, dtype, tp=None) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype``; under ``tp`` with a
    split vocabulary, the rank's rows (zeros for the other ranks' ids)
    summed over the group."""
    emb = params["embed"]
    if tp is None or not tp.layout.vocab:
        return emb[tokens.long()].to(dtype)
    from ..parallel.collectives import all_reduce_sum

    local = tokens.long() - tp.rank * emb.shape[0]
    mine = (local >= 0) & (local < emb.shape[0])
    rows = emb[torch.where(mine, local, torch.zeros_like(local))]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return all_reduce_sum(rows, tp.group).to(dtype)


def _columns_of(tp, split: bool):
    """The context of a column-parallel product (``wqkv``, ``w_gate_up``,
    the vocabulary's ``lm_head``): under ``tp`` with the part split, K1
    plans the rank's shard as the whole product."""
    if tp is None or not split:
        return contextlib.nullcontext()
    from ..kernels.quant_matmul import planned_as_whole

    return planned_as_whole(tp.layout.size)


def _row_parallel(x: torch.Tensor, w, tp, split: bool) -> torch.Tensor:
    """``x @ w`` of a row-parallel weight (``wo``, ``w_down``): under ``tp``
    with the part split, the float32 partial summed over the group and cast
    once, its fp8native input quantized with the group's row amaxes."""
    if tp is None or not split:
        return _dot(x, w)
    from ..parallel.collectives import all_reduce_sum
    from ..quant.dot import k_split_over

    with k_split_over(tp.group):
        if isinstance(w, QTensor):
            y = qdot(x, w, out_dtype=torch.float32)
        else:
            y = _matmul_f32(x, w.to(x.dtype))
    return all_reduce_sum(y, tp.group).to(x.dtype)


#: Layer li's dropout seed is ``dropout_seed + li · DROPOUT_LAYER_STRIDE``
#: (without it every layer would drop the same entries).
DROPOUT_LAYER_STRIDE = 7919


def remat_mode(remat) -> str:
    """The JAX knob's values (False/None/"none", True/"full", "dots") as a
    mode name: off, save nothing, save the GEMM outputs (JAX ``_remat_policy``)."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "full"):
        return "full"
    if remat == "dots":
        return "dots"
    raise ValueError(f"unknown remat policy {remat!r}; use False/'none', True/'full' or 'dots'")


def _ckpt(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint: its saved tensors are
    dropped after the forward and rebuilt by running ``fn`` again in the
    backward (nothing in a layer draws random numbers: dropout is a hash)."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def _call(fn, *args):
    return fn(*args)


def _site_dot(x, w, site: str, dots, amaxes):
    """``x @ w`` for one GEMM site: ``_dot``, or the training closure
    ``dots[site]``, whose amaxes land in ``amaxes[site]``."""
    if dots is None:
        return _dot(x, w)
    y, amaxes[site] = dots[site](x, w)
    return y


def _split_qkv(qkv, lp, cfg: ModelConfig, B: int, S: int):
    """The QKV projection's output → q, k, v heads (bias added, QK-norm)."""
    if "bqkv" in lp:
        qkv = qkv + lp["bqkv"].to(qkv.dtype)
    q, kk, vv = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    kk = kk.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    vv = vv.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if "q_norm" in lp:
        q = rmsnorm(q, lp["q_norm"], cfg.rms_eps)
        kk = rmsnorm(kk, lp["k_norm"], cfg.rms_eps)
    return q, kk, vv


def _qkv(h, lp, cfg: ModelConfig, B: int, S: int, dots=None, amaxes=None):
    return _split_qkv(_site_dot(h, lp["wqkv"], "attn_qkv", dots, amaxes), lp, cfg, B, S)


def _swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = torch.chunk(gate_up, 2, dim=-1)
    return F.silu(gate.float()).to(up.dtype) * up


def _mlp(x, lp, cfg: ModelConfig, dots=None, amaxes=None, seg=_call, tp=None):
    h = seg(rmsnorm, x, lp["norm_mlp"], cfg.rms_eps)
    with _columns_of(tp, tp is not None and tp.layout.mlp):
        h = _site_dot(h, lp["w_gate_up"], "mlp_gate_up", dots, amaxes)
    h = seg(_swiglu, h)
    if tp is not None:
        return x + _row_parallel(h, lp["w_down"], tp, tp.layout.mlp)
    return x + _site_dot(h, lp["w_down"], "mlp_down", dots, amaxes)


def _layer_body(x, lp, cos, sin, cfg: ModelConfig, attend, dots=None, amaxes=None,
                seg=_call, tp=None):
    """One decoder layer over a sequence: ``attend(q, k, v) -> attn`` (causal
    self-attention or the cache), the GEMMs through ``dots`` when given (the
    FP8 training path; their amaxes land in ``amaxes``). ``seg(fn, *args)``
    runs each elementwise segment between the GEMM sites and attention
    (``_ckpt`` under ``remat="dots"``). No rotary for ALiBi models (``cos``
    None). ``tp``: a rank's layer (module docstring; serving only)."""
    B, S, _ = x.shape

    def rotary(qkv):
        q, kk, vv = _split_qkv(qkv, lp, cfg, B, S)
        if cos is None:
            return q, kk, vv
        return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), vv

    h = seg(rmsnorm, x, lp["norm_attn"], cfg.rms_eps)
    with _columns_of(tp, tp is not None and tp.layout.heads):
        qkv = _site_dot(h, lp["wqkv"], "attn_qkv", dots, amaxes)
    attn = attend(*seg(rotary, qkv))
    if tp is not None:
        x = x + _row_parallel(attn.reshape(B, S, -1), lp["wo"], tp, tp.layout.heads)
    else:
        x = x + _site_dot(attn.reshape(B, S, -1), lp["wo"], "attn_out", dots, amaxes)
    return _mlp(x, lp, cfg, dots, amaxes, seg, tp)


def _run_layer(x, lp, cos, sin, cfg: ModelConfig, attend, mode: str, dots=None):
    """One training layer under the remat ``mode``; returns ``(x, amaxes)``,
    the amaxes of the first forward."""
    def body(x):
        amaxes = {}
        return _layer_body(x, lp, cos, sin, cfg, attend, dots, amaxes,
                           _ckpt if mode == "dots" else _call), amaxes

    return _ckpt(body, x) if mode == "full" else body(x)


def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig, *,
            cache: Optional[KVCache] = None, start_pos=0,
            kv_lens: Optional[torch.Tensor] = None,
            compute_dtype=torch.bfloat16, return_kv: bool = False,
            return_hidden: bool = False, remat=False, dropout_p: float = 0.0,
            dropout_seed: int = 0, cp_group=None, tp=None):
    """``tokens [B, S] -> (logits [B, S, V] float32, cache)``.

    ``cache=None``: causal self-attention; with ``return_kv`` the second
    value is the per-layer ``(K, V)``, each ``[L, B, S, Hk, Dh]``. With a
    cache: K/V are written at ``start_pos`` in place and the returned cache
    carries the new ``lens``. ``return_hidden`` returns the final-norm hidden
    states ``[B, S, D]`` in place of the logits (``_lm_head`` maps them).
    ``remat`` (``none|full|dots``) and ``dropout_p``/``dropout_seed`` apply
    to the cache-free (training) forward. ``cp_group``: context parallelism
    over that process group for the cache-free forward (every rank holds the
    whole sequence; attention rings over its chunks, ``ops/attention.py``).
    ``tp``: a rank's forward over its shard (module docstring); ``cfg`` is
    the rank's config. Serving only: not with remat, dropout or ``cp_group``.
    """
    mode = remat_mode(remat)
    if tp is not None and (mode != "none" or dropout_p or cp_group is not None):
        raise ValueError("tensor parallelism here is a serving option: no remat, dropout "
                         "or context parallelism")
    if cache is not None and (mode != "none" or dropout_p):
        raise ValueError("remat and dropout are training options: no cache")
    if cache is not None and cp_group is not None:
        raise ValueError("context parallelism is a training option: no cache")
    if return_kv and mode != "none":
        raise ValueError("return_kv reads the layers' K/V: not under remat")
    dev = params["embed"].device
    tokens = tokens.to(dev)
    x = _embed(params, tokens, compute_dtype, tp)
    B, S = tokens.shape
    start_pos = torch.as_tensor(start_pos, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    positions = start_pos[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    cos, sin = _rope_tables(cfg, positions)
    slopes = _rank_alibi(cfg, dev, tp)
    ks, vs = [], []
    for li, lp in enumerate(unstack_layers(params["layers"])):
        if cache is None:
            def attend(q, kk, vv, li=li):
                if return_kv:
                    ks.append(kk)
                    vs.append(vv)
                return attention(q, kk, vv, causal=True, kv_lens=kv_lens,
                                 window=cfg.sliding_window, alibi_slopes=slopes,
                                 dropout_p=dropout_p,
                                 dropout_seed=dropout_seed + li * DROPOUT_LAYER_STRIDE,
                                 cp_group=cp_group)
            x = (_layer_body(x, lp, cos, sin, cfg, attend, tp=tp) if tp is not None
                 else _run_layer(x, lp, cos, sin, cfg, attend, mode)[0])
        else:
            def attend(q, kk, vv, li=li):
                return cache_append_attend(
                    q, kk, vv, (cache.k, cache.v, cache.k_scale[li], cache.v_scale[li], li),
                    start_pos, kv_lens, window=cfg.sliding_window, alibi_slopes=slopes)[0]
            x = _layer_body(x, lp, cos, sin, cfg, attend, tp=tp)
    if cache is None:
        new_cache = (torch.stack(ks), torch.stack(vs)) if return_kv else None
    else:
        new_cache = dataclasses.replace(
            cache, lens=torch.maximum(cache.lens, start_pos + S))
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    if return_hidden:
        return x, new_cache
    return _lm_head(params, x, cfg, tp), new_cache


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` of bf16 operands with float32 output (the
    JAX package's ``preferred_element_type=float32``)."""
    y = matmul_f32(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def lm_head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    """The ``[D, V]`` lm_head matrix as a plain tensor (tied: ``embed.T``),
    for the chunked cross-entropy. Raises on quantized parameters."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        w = params["embed"]
        if isinstance(w, QTensor):
            raise TypeError("chunked CE needs unquantized embed weights")
        return w.t()
    lm = params["lm_head"]
    if isinstance(lm, QTensor):
        raise TypeError("chunked CE needs an unquantized lm_head")
    return lm


def _lm_head(params, x, cfg: ModelConfig, tp=None) -> torch.Tensor:
    if tp is not None and tp.layout.vocab:  # the ranks' columns of the vocabulary
        from ..parallel.collectives import all_gather

        with _columns_of(tp, True):
            logits = _lm_head(params, x, cfg)
        return all_gather(logits, -1, tp.group)
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return _matmul_f32(x, params["embed"].to(x.dtype).t())
    lm = params["lm_head"]
    if isinstance(lm, QTensor):
        return qdot(x, lm, out_dtype=torch.float32)
    return _matmul_f32(x, lm.to(x.dtype))


def forward_decode_arena(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
                         k_arena: torch.Tensor, v_arena: torch.Tensor, lens: torch.Tensor,
                         *, kv_scale=1.0, window: Optional[int] = None, tp=None):
    """Single-token decode over the ``[L, B, Hk, S, Dh]`` arena through K2,
    which rotates q and the new K, quantizes and appends the new token at
    ``lens`` (in place) and attends. Returns ``(logits [B, 1, V], k_arena,
    v_arena)``. ALiBi models take their slopes in K2 and no rotary. ``tp``:
    a rank's step over its shard and its heads' arena (module docstring)."""
    B, S_tok = tokens.shape
    if S_tok != 1:
        raise ValueError(f"forward_decode_arena takes one token per sequence, got {S_tok}")
    dev = params["embed"].device
    lens = lens.to(device=dev, dtype=torch.int32)
    x = _embed(params, tokens.to(dev), torch.bfloat16, tp)
    cos, sin = _rope_tables(cfg, lens[:, None])
    slopes = _rank_alibi(cfg, dev, tp)
    k_sc, v_sc = kv_scale if isinstance(kv_scale, tuple) else (kv_scale, kv_scale)
    lengths = lens + 1
    for li, lp in enumerate(unstack_layers(params["layers"])):
        h = rmsnorm(x, lp["norm_attn"], cfg.rms_eps)
        with _columns_of(tp, tp is not None and tp.layout.heads):
            q, kk, vv = _qkv(h, lp, cfg, B, 1)
        attn, k_arena, v_arena = decode_attention_arena(
            q[:, 0], k_arena, v_arena, lengths, li, new_k=kk[:, 0], new_v=vv[:, 0],
            rope_cos_sin=None if cos is None else (cos[:, 0], sin[:, 0]), k_scale=k_sc,
            v_scale=v_sc, window=window, alibi_slopes=slopes)
        if tp is not None:
            x = x + _row_parallel(attn.reshape(B, 1, -1), lp["wo"], tp, tp.layout.heads)
        else:
            x = x + _dot(attn.reshape(B, 1, -1), lp["wo"])
        x = _mlp(x, lp, cfg, tp=tp)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _lm_head(params, x, cfg, tp), k_arena, v_arena


def forward_paged(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
                  k_pages: torch.Tensor, v_pages: torch.Tensor, page_tables: torch.Tensor,
                  lens: torch.Tensor, *, kv_scale: float = 1.0,
                  compute_dtype=torch.bfloat16):
    """Single-token decode over the ``[P, L, Hk, page, Dh]`` paged pools.

    Rotary is applied to q and the new K at positions ``lens`` here; K5 then
    quantizes and appends each slot's new K/V at ``lens`` through its block
    table row (in place) and attends. Returns ``(logits [B, 1, V] float32,
    k_pages, v_pages)``. ALiBi models take their slopes in K5 and no rotary.
    """
    B, S_tok = tokens.shape
    if S_tok != 1:
        raise ValueError(f"forward_paged takes one token per sequence, got {S_tok}")
    dev = params["embed"].device
    lens = lens.to(device=dev, dtype=torch.int32)
    tables = page_tables.to(device=dev, dtype=torch.int32)
    x = params["embed"][tokens.to(dev).long()].to(compute_dtype)
    cos, sin = _rope_tables(cfg, lens[:, None])
    slopes = _alibi(cfg, dev)
    lengths = lens + 1
    for li, lp in enumerate(unstack_layers(params["layers"])):
        h = rmsnorm(x, lp["norm_attn"], cfg.rms_eps)
        q, kk, vv = _qkv(h, lp, cfg, B, 1)
        if cos is not None:
            q, kk = apply_rope(q, cos, sin), apply_rope(kk, cos, sin)
        attn, k_pages, v_pages = paged_attention(
            q[:, 0], k_pages, v_pages, lengths, tables, li, kv_scale=kv_scale,
            window=cfg.sliding_window, new_k=kk[:, 0], new_v=vv[:, 0], alibi_slopes=slopes)
        x = x + _dot(attn.reshape(B, 1, -1), lp["wo"])
        x = _mlp(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    return _lm_head(params, x, cfg), k_pages, v_pages


def forward_fp8_train(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
                      recipes: RecipeSet, scales: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                      sinks: Dict[str, torch.Tensor], *, compute_dtype=torch.bfloat16,
                      remat=False, return_hidden: bool = False, dropout_p: float = 0.0,
                      dropout_seed: int = 0, cp_group=None):
    """FP8 training forward: the four GEMM sites of every layer run through
    :func:`~..quant.fp8_dot` with the recipe the set assigns to their role.

    ``scales[site]`` = (x_scale [L], w_scale [L]) delayed scales;
    ``sinks[site]`` = zeros [L] that require a gradient — after ``backward``
    their gradients are the backward-pass amaxes. Returns ``(logits
    [B, S, V] float32 — or the final-norm hidden states [B, S, D] with
    ``return_hidden`` — , {site: DotAmaxes stacked [L]})``. ``remat``:
    ``none|full|dots`` per layer (each sink still gets one backward, and the
    amaxes are the first forward's). ``dropout_p``/``dropout_seed``:
    attention dropout as in :func:`forward` (the JAX package's fp8 forward
    has none, and the ``Trainer`` passes dropout on the bf16 recipe only, as
    the JAX trainer does). ``cp_group``: context parallelism, as in
    :func:`forward`.
    """
    mode = remat_mode(remat)
    dev = params["embed"].device
    tokens = tokens.to(dev)
    x = params["embed"][tokens.long()].to(compute_dtype)
    S = tokens.shape[1]
    cos, sin = _rope_tables(cfg, torch.arange(S, dtype=torch.int32, device=dev)[None, :])
    slopes = _alibi(cfg, dev)

    per_layer = []
    for li, lp in enumerate(unstack_layers(params["layers"])):
        def attend(q, kk, vv, li=li):
            return attention(q, kk, vv, causal=True, window=cfg.sliding_window,
                             alibi_slopes=slopes, dropout_p=dropout_p,
                             dropout_seed=dropout_seed + li * DROPOUT_LAYER_STRIDE,
                             cp_group=cp_group)

        dots = _make_train_dots(
            recipes, {s: (scales[s][0][li], scales[s][1][li]) for s in DOT_SITES},
            {s: sinks[s][li] for s in DOT_SITES})
        x, amaxes = _run_layer(x, lp, cos, sin, cfg, attend, mode, dots)
        per_layer.append(amaxes)
    stacked = {s: DotAmaxes(*(torch.stack(t) for t in zip(*(a[s] for a in per_layer))))
               for s in DOT_SITES}
    x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
    if return_hidden:
        return x, stacked
    return _lm_head(params, x, cfg), stacked
