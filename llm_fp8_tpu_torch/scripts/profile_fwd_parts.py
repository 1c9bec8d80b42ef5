"""Same-run decomposition of the Llama-3.2-1B forward into its parts.

Counterpart of ``scripts/profile_fwd_parts.py`` of the JAX package. In one
process it times, per step of ``steps`` (ms per step, the median of
``trials``):

  gemms  - the per-layer GEMM chain (qkv, wo, gate|up, down) as bare
           ``torch.matmul`` over all layers, at the model's shapes and dtypes
  flash  - ``layers`` x ``ops.attention.attention(..., causal=True)`` at the
           model's shapes: the flash-attention forward (K3) on the card
  norms  - 2 x ``layers`` x the fused residual RMSNorm (K8) at the model's
           shapes
  model  - the port's ``forward`` on bf16 ``init_params`` weights, with
           ``profile_model`` (``PROFILE_MODEL=1`` from the command line)

and ``gemm_ideal_ms``, the GEMM chain's FLOPs at the card's bf16 peak
(``utils.backend.card_peaks``; null off the card). On the
card each part's loop of ``steps`` is captured once in a CUDA graph and the
graph replayed between CUDA events (no host work per step, as the JAX
package's ``scan`` under ``jit``); ``model`` runs eagerly between CUDA
events, since its rotary tables are copied from the host. On the CPU the host
clock times them.

    PROFILE_MODEL=1 python -m llm_fp8_tpu_torch.scripts.profile_fwd_parts   # the card
    python -c "from llm_fp8_tpu_torch.scripts.profile_fwd_parts import main; \\
        main(device='cpu', model='debug-tiny', batch=2, seq=16, steps=2, trials=1)"

Prints one JSON object per part as it finishes, then all of them in one
object as the last line.
"""
from __future__ import annotations

import json
import os
import statistics
import time

import torch

from ..kernels.rmsnorm import rmsnorm_residual_fused
from ..models import get_config
from ..models.llama import forward, init_params
from ..ops.attention import attention
from ..utils.backend import card_peaks, resolve_device

__all__ = ["main"]

def _time(fn, args, dev: torch.device, steps: int, trials: int, graph: bool) -> float:
    """ms per step of ``fn(*args)``, which runs ``steps`` steps."""
    if dev.type != "cuda":
        fn(*args)
        times = []
        for _ in range(trials):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
        return statistics.median(times) / steps * 1e3
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream(dev).wait_stream(side)
    run = lambda: fn(*args)  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn(*args)
        run = g.replay
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    return statistics.median(times) / steps


def main(*, model: str = "llama-3.2-1b", batch: int = 8, seq: int = 512, steps: int = 8,
         trials: int = 3, profile_model: bool = False, device=None, echo=print) -> dict:
    """Time the parts; returns the result object (also printed through
    ``echo``). ``device`` defaults to the card (:func:`resolve_device`)."""
    dev = resolve_device(device)
    cfg = get_config(model)
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    T = batch * seq
    params = init_params(cfg, device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    x = randn(T, D)
    lay = params["layers"]
    ws = [(lay["wqkv"][i], lay["wo"][i], lay["w_gate_up"][i], lay["w_down"][i])
          for i in range(L)]

    def gemms(c):
        for _ in range(steps):
            for wqkv, wo, wgu, wdn in ws:
                qkv = c @ wqkv
                att = qkv[:, :Hq * Dh] @ wo
                gu = (c + att) @ wgu
                c = c + (gu[:, :I] * gu[:, I:]) @ wdn
        return c

    q, k, v = randn(batch, seq, Hq, Dh), randn(batch, seq, Hk, Dh), randn(batch, seq, Hk, Dh)
    zero = torch.zeros((batch,), dtype=torch.int32, device=dev)  # made before any capture

    def flash(q, k, v):
        c = torch.zeros((), device=dev)
        for _ in range(steps):
            for _ in range(L):
                o = attention((q + c).to(q.dtype), k, v, causal=True, q_offset=zero)
                c = c + o[0, 0, 0, 0].float()
        return c

    g = torch.ones((D,), dtype=torch.bfloat16, device=dev)

    def norms(c):
        for _ in range(steps):
            for _ in range(2 * L):
                h, r = rmsnorm_residual_fused(c, c, g, cfg.rms_eps)
                c = h + r * 1e-6
        return c

    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)

    def model_fwd(tokens):
        c = torch.zeros((), device=dev)
        for _ in range(steps):
            # A live float dependency on the output from step to step.
            lo, _ = forward(params, tokens + c.to(torch.int64), cfg)
            c = lo[0, 0, 0].float() * 1e-30
        return c

    res = {}
    with torch.no_grad():
        for name, fn, args in (("gemms_ms", gemms, (x,)), ("flash_ms", flash, (q, k, v)),
                               ("norms_ms", norms, (x,))):
            res[name] = _time(fn, args, dev, steps, trials, graph=True)
            echo(json.dumps({name: res[name]}))
        if profile_model:
            res["model_ms"] = _time(model_fwd, (tokens,), dev, steps, trials, graph=False)
            echo(json.dumps({"model_ms": res["model_ms"]}))
    gemm_flops = 2 * T * (D * (Hq + 2 * Hk) * Dh + Hq * Dh * D + D * 2 * I + I * D) * L
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peaks = card_peaks(name) if dev.type == "cuda" else None
    res["gemm_ideal_ms"] = gemm_flops / peaks[1] * 1e3 if peaks else None
    res["device"] = name
    res["timing"] = ("CUDA graph of each part's steps between CUDA events; model eager"
                     if dev.type == "cuda" else "host clock")
    echo(json.dumps(res))
    return res


if __name__ == "__main__":
    main(profile_model=os.environ.get("PROFILE_MODEL", "0") == "1")
