"""What the GPT-2, NeoX, Gemma and MoE families share (the JAX package
repeats it in ``models/gpt2.py``, ``models/neox.py``, ``models/gemma.py`` and
``models/moe.py``): the layer loop with or without the :class:`~.llama.KVCache` and with the training
knobs (remat, attention dropout) and a per-layer window, the float32 logits
of a tied or unquantized head, and the state-dict readers of the HF packers.

The GPT-2 and NeoX families compute in float32 (``compute_dtype``), so their
head product
``x @ head.T`` (JAX: ``jnp.dot(x, head.T.astype(x.dtype))``, which XLA fuses)
needs the bf16 head as float32. Converting it at every call would write a
float32 copy of it per step (1.18 GB for Falcon-7B's 65024 x 4544
embedding); :func:`with_f32_head` makes that copy once (the serving engine
calls it at construction) and :func:`lm_logits` uses it when present. A
training tree carries no such copy (the ``Trainer`` refuses one): the float32
head is the float32 master weight itself, and the gradient reaches it.

Training (no cache): ``remat`` as the Llama family's (``"full"`` checkpoints
each layer whole; ``"dots"`` checkpoints the elementwise segments a layer
passes to ``seg``, so the GEMM outputs and the attention output are kept:
JAX's ``dots`` policy with its ``attn_out`` name), and attention dropout with
layer li's seed ``dropout_seed + li·DROPOUT_LAYER_STRIDE``, as JAX's
``seed0 + aux * 7919``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..ops.attention import attention
from ..utils.backend import resolve_device
from .llama import (DROPOUT_LAYER_STRIDE, _call, _ckpt, _matmul_f32, cache_append_attend,
                    remat_mode, unstack_layers)

__all__ = ["head_weight", "with_f32_head", "lm_logits", "run_layers", "state_getter",
           "stacker", "HEAD_F32", "training_knobs"]

#: Key of the float32 copy of the head in a parameter tree.
HEAD_F32 = "head_f32"


def head_weight(params: Dict[str, Any]):
    """The ``[V, D]`` head: ``lm_head`` where the tree has one, else the tied
    embedding, ``wte`` (GPT-2 ties always; NeoX unless its config unties) or
    ``embed`` (Gemma)."""
    for key in ("lm_head", "wte"):
        if key in params:
            return params[key]
    return params["embed"]


def with_f32_head(params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with a float32 copy of a non-float32 head under
    :data:`HEAD_F32` (made once, here); other trees, and Gemma's (head
    ``embed``: a bf16-compute family), unchanged."""
    head = head_weight(params)
    if head.dtype == torch.float32 or HEAD_F32 in params or "embed" in params:
        return params
    return {**params, HEAD_F32: head.float()}


def lm_logits(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """float32 logits ``x @ head.T`` with the head in x's dtype: a float32
    product for a float32 x (from the :func:`with_f32_head` copy where there
    is one), a bf16 product with float32 output for a bf16 x."""
    if x.dtype == torch.float32:
        head = params.get(HEAD_F32)
        if head is None:
            head = head_weight(params).float()
        return x @ head.t()
    return _matmul_f32(x, head_weight(params).to(x.dtype).t())


def training_knobs(cache, attn_impl: str, remat, unroll: int, dropout_p: float) -> str:
    """Check the JAX forwards' training knobs; returns the remat mode.
    ``attn_impl`` is ``"auto"`` only (the port has one attention route per
    device), ``unroll`` 1 only (a JAX scan knob: the layers are a Python
    loop), and remat and dropout need the cache-free (training) forward."""
    mode = remat_mode(remat)
    if attn_impl != "auto":
        raise NotImplementedError(f"attn_impl {attn_impl!r}: the port has one attention "
                                  "route per device ('auto')")
    if unroll != 1:
        raise NotImplementedError("unroll is a JAX scan knob; the port's layer loop has no "
                                  "counterpart (leave it at 1)")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p {dropout_p} outside [0, 1)")
    if cache is not None and (mode != "none" or dropout_p):
        raise ValueError("remat and dropout are training options: no cache")
    return mode


def run_layers(params: Dict[str, Any], x: torch.Tensor, layer: Callable, *,
               cache=None, start_pos: torch.Tensor, kv_lens=None, remat: str = "none",
               dropout_p: float = 0.0, dropout_seed: int = 0, window=None, with_aux=False,
               **attn_kw):
    """The decoder layers over ``x``: ``layer(x, lp, attend, seg) -> x`` per
    layer, where ``attend(q, k, v)`` is causal self-attention (no cache; with
    ``dropout_p`` at layer li's seed) or the cache's append-and-attend at
    ``start_pos`` (written in place), both masked to ``kv_lens``, to
    ``window`` (None, a width, or a callable of the layer index giving
    either: Gemma's even layers slide) and given ``attn_kw`` (``scale``,
    ``softcap``, ``alibi_slopes``), and ``seg(fn, *args)`` runs one
    of the layer's elementwise segments (checkpointed under ``remat="dots"``).
    ``remat`` is a mode of :func:`~.llama.remat_mode` (``"full"``: each layer
    under a checkpoint). Returns ``(x, new_cache)``; with ``with_aux`` the
    layer returns ``(x, aux)`` (also from under a ``"full"`` checkpoint) and
    the list of the layers' ``aux`` comes third (the MoE router's loss)."""
    seg = _ckpt if remat == "dots" else _call
    auxes = []
    for li, lp in enumerate(unstack_layers(params["layers"])):
        w = window(li) if callable(window) else window
        if cache is None:
            def attend(q, k, v, li=li, w=w):
                return attention(q, k, v, causal=True, kv_lens=kv_lens, window=w,
                                 dropout_p=dropout_p,
                                 dropout_seed=dropout_seed + li * DROPOUT_LAYER_STRIDE,
                                 **attn_kw)
        else:
            def attend(q, k, v, li=li, w=w):
                return cache_append_attend(
                    q, k, v, (cache.k, cache.v, cache.k_scale[li], cache.v_scale[li], li),
                    start_pos, kv_lens, window=w, **attn_kw)[0]
        if remat == "full":
            out = _ckpt(lambda x, lp=lp, attend=attend: layer(x, lp, attend, seg), x)
        else:
            out = layer(x, lp, attend, seg)
        if with_aux:
            x, aux = out
            auxes.append(aux)
        else:
            x = out
    new_cache = None if cache is None else dataclasses.replace(
        cache, lens=torch.maximum(cache.lens, start_pos + x.shape[1]))
    return (x, new_cache, auxes) if with_aux else (x, new_cache)


def state_getter(sd, dtype, device):
    """``g(name)``: the state-dict entry ``name`` (a tensor or an array) as a
    ``dtype`` tensor on ``device``."""
    dev = resolve_device(device)

    def g(name):
        t = sd[name]
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t))
        return t.to(device=dev, dtype=dtype)

    return g


def stacker(g, L):
    """``stack(fmt, tr=False)``: layers 0..L-1 of ``fmt.format(i)`` stacked,
    each transposed (an ``nn.Linear`` ``[out, in]``) when ``tr``."""
    def stack(fmt, tr=False):
        return torch.stack([g(fmt.format(i)).t() if tr else g(fmt.format(i))
                            for i in range(L)])
    return stack
