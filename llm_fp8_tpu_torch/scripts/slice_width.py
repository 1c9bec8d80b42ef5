"""How the card-vs-CPU difference of a 2-layer slice grows with the model.

``chip_smoke.py``'s slices run a model cut to 2 layers on the card and on
the CPU (weights LAYERWISE fp8, qdot pinned to the ``xla`` route: K1 on the
card, its plain version on the CPU) and hold the logits together. This
script takes the prefill of those slices (40 tokens in a 64-token bucket,
the same seeds) at several models and reads, per variant:

  layers  - after each decoder layer, the residual stream's card-vs-CPU
            difference: largest ``|d|`` and ``rms(d)`` over ``rms(x)``, and
            the share of bf16 values whose bits differ
  hidden  - the same for the final-norm hidden states
  logits  - the largest ``|d|`` (what the slices hold), ``rms(d)``, the
            logits' largest ``|value|`` and their standard deviation, and the
            largest ``|d|`` in units of that deviation

Variants: a width sweep of Llama models (1B, 3B, 8B: hidden 2048-4096),
Baichuan-13B (hidden 5120, ALiBi, vocab 64000), Baichuan-13B with rotary in
place of ALiBi and with the 1B's vocab, Baichuan-13B with the card's
products computed by ``torch.mm`` in place of K1 (the same function through
the library: is K1 the cause?), and two references whose projections are
summed in float64 (the 1B and Baichuan-13B): each side's distance to them
says which of the two lies nearer exact sums.

    python -m llm_fp8_tpu_torch.scripts.slice_width            # on the card
    python -m llm_fp8_tpu_torch.scripts.slice_width --variants llama-3.2-1b

Prints one JSON object per variant, then all of them in one object as the
last line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from ..models import forward, get_config
from ..models import llama
from ..models.llama import init_params, quantize_params
from ..quant import LAYERWISE
from ..quant.dot import _dot_f32

__all__ = ["main", "VARIANTS"]

#: name -> (model, config overrides, card products, float64 reference)
VARIANTS = {
    "llama-3.2-1b": ("llama-3.2-1b", {}, "k1", False),
    "llama-3.2-3b": ("llama-3.2-3b", {}, "k1", False),
    "llama-3.1-8b": ("llama-3.1-8b", {}, "k1", False),
    "baichuan-13b": ("baichuan-13b", {}, "k1", False),
    "baichuan-13b rotary": ("baichuan-13b", {"alibi": False}, "k1", False),
    "baichuan-13b vocab 128256": ("baichuan-13b", {"vocab_size": 128256}, "k1", False),
    "baichuan-13b torch.mm products": ("baichuan-13b", {}, "mm", False),
    "llama-3.2-1b float64 sums": ("llama-3.2-1b", {}, "k1", True),
    "baichuan-13b float64 sums": ("baichuan-13b", {}, "k1", True),
}


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if hasattr(tree, "qvalue"):
        return tree.to("cpu")
    return tree.detach().cpu()


def _mm_qdot(x, w, *, out_dtype=None, impl=None):
    """The xla route's function (codes as bf16, float32 sums, the tensor
    scale after) through ``torch.mm``, for a LAYERWISE weight."""
    y = _dot_f32(x, w.unpack().to(x.dtype)) * w.scale.float().reshape(-1)
    return y.to(out_dtype or x.dtype)


def _f64_qdot(x, w, *, out_dtype=None, impl=None):
    """The same function with the sums in float64."""
    y = (x.double() @ w.unpack().double()) * w.scale.double().reshape(-1)
    return y.to(out_dtype or x.dtype)


@contextlib.contextmanager
def _traced(qdot=None):
    """Record each decoder layer's output; ``qdot`` in place of the model's."""
    outs = []
    body, real = llama._layer_body, llama.qdot

    def recorded(*a, **kw):
        y = body(*a, **kw)
        outs.append(y.detach().cpu())
        return y

    llama._layer_body = recorded
    if qdot is not None:
        llama.qdot = qdot
    try:
        yield outs
    finally:
        llama._layer_body, llama.qdot = body, real


def _run(params, prompt, cfg, lens, qdot=None):
    with _traced(qdot) as layers:
        hidden, _ = forward(params, prompt, cfg, kv_lens=lens, return_hidden=True)
        logits = llama._lm_head(params, hidden, cfg)
    n = int(lens[0])
    return dict(layers=[x[0, :n] for x in layers], hidden=hidden[0, :n].detach().cpu(),
                logits=logits[0, :n].float().detach().cpu())


def _diff(a, b):
    d = a.float() - b.float()
    rms = b.float().square().mean().sqrt().item()
    return dict(max_abs=d.abs().max().item(), rms_rel=d.square().mean().sqrt().item() / rms,
                max_rel=d.abs().max().item() / rms,
                bits_differ=(a.view(torch.int16) != b.view(torch.int16)).float().mean().item()
                if a.dtype == torch.bfloat16 else None)


def _compare(a, b):
    lg = b["logits"]
    err = (a["logits"] - lg).abs()
    return dict(layers=[_diff(x, y) for x, y in zip(a["layers"], b["layers"])],
                hidden=_diff(a["hidden"], b["hidden"]),
                logits=dict(max_abs_err=err.max().item(),
                            rms_err=err.square().mean().sqrt().item(),
                            logits_max_abs=lg.abs().max().item(), logits_std=lg.std().item(),
                            max_abs_err_over_std=err.max().item() / lg.std().item()))


def probe(name: str, dev: torch.device) -> dict:
    model, overrides, products, exact = VARIANTS[name]
    cfg = dataclasses.replace(get_config(model), num_layers=2, **overrides)
    t0 = time.perf_counter()
    params = quantize_params(init_params(cfg, device=dev, seed=7), LAYERWISE)
    n, bucket = 40, 64
    rng = torch.Generator().manual_seed(3)
    prompt = torch.zeros((1, bucket), dtype=torch.int64)
    prompt[0, :n] = torch.randint(1, cfg.vocab_size, (n,), generator=rng)
    lens = torch.tensor([n])
    card = _run(params, prompt.to(dev), cfg, lens.to(dev),
                _mm_qdot if products == "mm" else None)
    cpu_params = _cpu(params)
    del params
    torch.cuda.empty_cache()
    cpu = _run(cpu_params, prompt, cfg, lens)
    res = dict(variant=name, config=dict(hidden=cfg.hidden_size, heads=cfg.num_heads,
                                         kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                                         intermediate=cfg.intermediate_size,
                                         vocab=cfg.vocab_size, alibi=cfg.alibi),
               card_products=products, card_vs_cpu=_compare(card, cpu))
    if exact:
        ref = _run(cpu_params, prompt, cfg, lens, _f64_qdot)
        res["card_vs_float64_sums"] = _compare(card, ref)
        res["cpu_vs_float64_sums"] = _compare(cpu, ref)
    res["s"] = time.perf_counter() - t0
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slice_width: needs a CUDA card")
    os.environ["LLM_FP8_QDOT"] = "xla"
    dev = torch.device("cuda", 0)
    out = {}
    for name in args.variants.split(","):
        out[name] = probe(name, dev)
        print(json.dumps(out[name]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
