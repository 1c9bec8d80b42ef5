#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llm_fp8_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

Phases, in order; any failure exits non-zero before the last line:

1. card: ``nvidia-smi`` name and power limit; build every kernel with nvcc.
2. kernels: each CUDA kernel against its plain PyTorch version on the card at
   the main path's shapes (Llama-3.2-1B), with the tolerance stated; the
   kernel's median time, the plain version's, one PyTorch library call as a
   yardstick (timed only) and the bound (bytes or FLOPs over the card's peak).
3. slice: Llama-3.2-1B at full width cut to 2 layers, LAYERWISE fp8 weights:
   one prefill and two arena decode steps on the card and on the CPU (plain
   versions), logits compared; then the same through the bf16 KVCache path.
4. serving: Llama-3.2-1B, all 16 layers, fp8 weights, fp8 KV through the
   engine (8 requests), then int8 KV (2 requests, calibration); launch counts
   of every kernel are read around the fp8 run and must all be > 0.
5. a ``{"kernels": [...]}`` JSON line, then the card's name and power limit,
   then ``{"ok": true, "device": {...}}`` as the last line.

With ``--out DIR`` the details of every case go to ``DIR/chip_smoke.json``
and the compiler's logs to ``DIR/nvcc_*.log``.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates (data sheets, dense): bytes/s of device memory, bf16 FLOP/s.
_PEAKS = (("H100 NVL", 3.9e12, 835e12), ("H100 PCIe", 2.0e12, 756e12),
          ("H200", 4.8e12, 989e12), ("H100", 3.35e12, 989e12))


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return bw, flops
    return _PEAKS[-1][1:]


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int = 20, rounds: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph, the
    graph replayed ``rounds`` times between CUDA events, median per call.
    The graph takes the host's launch overhead out of the reading."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def eager_ms(fn, calls: int = 20, rounds: int = 5) -> float:
    """Time of one eager call, host launch overhead included (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cycler(items):
    """A callable returning the next item of ``items`` on each call (used to
    rotate through weight copies larger than the 50 MB L2 cache)."""
    state = {"i": 0}

    def nxt():
        item = items[state["i"] % len(items)]
        state["i"] += 1
        return item

    return nxt


def bound_ms(nbytes: float, flops: float, bw: float, peak: float):
    t_b, t_f = nbytes / bw, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def kernel_cases(dev, bw, peak, log):
    import torch
    import torch.nn.functional as F

    from llm_fp8_tpu_torch.kernels import decode_attention as k2
    from llm_fp8_tpu_torch.kernels import flash_attention as k3
    from llm_fp8_tpu_torch.kernels import quant_matmul as k1
    from llm_fp8_tpu_torch.kernels._common import fp8_to_bf16_ftz
    from llm_fp8_tpu_torch.quant import E4M3, E5M2, INT8, quantize, quantize_mx

    g = torch.Generator(device=dev).manual_seed(1234)
    cases = []

    # ---- K1 at every Llama-3.2-1B projection shape ----
    shapes = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w_gate_up": (2048, 16384),
              "w_down": (8192, 2048)}
    runs = [(n, m, mode, E4M3) for n in shapes for m in (8, 128)
            for mode in ("channel", "tensor", "mx")]
    runs += [("w_gate_up", 8, "channel", INT8), ("w_gate_up", 128, "channel", INT8),
             ("wqkv", 8, "channel", E5M2)]
    for name, M, mode, fmt in runs:
        K, N = shapes[name]
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        if mode == "mx":
            qt = quantize_mx(w, fmt, block_axis=0, flush_subnormal=True)
        else:
            qt = quantize(w, fmt, axes=None if mode == "tensor" else (0,),
                          flush_subnormal=True)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        got = k1.quant_matmul(x, qt.qvalue, qt.scale, mode=mode)
        ref = k1.quant_matmul_plain(x, qt.qvalue, qt.scale, mode=mode)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -7 * ref.float().abs().max().item()
        check(math.isfinite(err) and err <= tol,
              f"K1 {name} M={M} {mode} {fmt.name}: err {err} > tol {tol}")
        # Rotate weight copies past the L2 cache: decode finds weights cold.
        copies = max(1, math.ceil(200e6 / (K * N)))
        ws = [qt.qvalue.clone() for _ in range(copies)]
        wdq = [(qt.dequantize(torch.bfloat16)) for _ in range(max(1, copies // 2))]
        nw, nd = cycler(ws), cycler(wdq)
        ms = cuda_ms(lambda: k1.quant_matmul(x, nw(), qt.scale, mode=mode))
        call_ms = eager_ms(lambda: k1.quant_matmul(x, nw(), qt.scale, mode=mode))
        plain_ms = cuda_ms(lambda: k1.quant_matmul_plain(x, nw(), qt.scale, mode=mode),
                           calls=4, rounds=3)
        lib_ms = cuda_ms(lambda: torch.matmul(x, nd()))
        nbytes = M * K * 2 + K * N + qt.scale.numel() * qt.scale.element_size() + M * N * 2
        b_ms, b_by = bound_ms(nbytes, 2.0 * M * N * K, bw, peak)
        case = dict(kernel="quant_matmul", case=f"{name} M={M} {mode} {fmt.name}",
                    max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        cases.append(case)
        log(case)
        del ws, wdq

    # ---- K2 at B 8, Hq 32, Hk 8, D 64, S 1024, 16 layers ----
    L, B, Hq, Hk, D, S = 16, 8, 32, 8, 64, 1024
    lengths = torch.tensor([1, 37, 200, 511, 512, 640, 1000, 1024], dtype=torch.int32,
                           device=dev)
    for dtype in (torch.float8_e4m3fn, torch.int8, torch.float8_e5m2, torch.bfloat16):
        integer = dtype == torch.int8
        ks = (torch.rand((Hk,), generator=g, device=dev) + 0.5) * (4 / 127 if integer else 1)
        vs = (torch.rand((Hk,), generator=g, device=dev) + 0.5) * (4 / 127 if integer else 1)

        def fill(scales):
            x = torch.randn((L, B, Hk, S, D), generator=g, device=dev)
            if dtype == torch.bfloat16:
                return x.to(dtype)
            fmax = 127.0 if integer else float(torch.finfo(dtype).max)
            y = torch.clamp(x / scales.reshape(1, 1, Hk, 1, 1), -fmax, fmax)
            return (torch.round(y) if integer else y).to(dtype)

        ka, va = fill(ks), fill(vs)
        q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        nk = torch.randn((B, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        nv = torch.randn((B, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        ang = (lengths - 1).float()[:, None] * torch.rand((1, D // 2), generator=g, device=dev)
        cos, sin = torch.cos(ang), torch.sin(ang)
        layer = 5
        kw = dict(new_k=nk, new_v=nv, rope_cos_sin=(cos, sin), k_scale=ks, v_scale=vs)
        ka_k, va_k = ka.clone(), va.clone()
        got, _, _ = k2.decode_attention_arena(q, ka_k, va_k, lengths, layer, **kw)
        ka_p, va_p = ka.clone(), va.clone()
        ref = k2.decode_attention_arena_plain(
            q, ka_p, va_p, lengths, layer, new_k=nk, new_v=nv, cos=cos, sin=sin,
            k_scale=ks, v_scale=vs, scale=D ** -0.5, window=None, softcap=None)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 1e-2 * max(1.0, ref.float().abs().max().item())
        same_codes = bool(torch.equal(ka_k.view(torch.uint8), ka_p.view(torch.uint8))
                          and torch.equal(va_k.view(torch.uint8), va_p.view(torch.uint8)))
        check(math.isfinite(err) and err <= tol, f"K2 {dtype}: err {err} > tol {tol}")
        check(same_codes, f"K2 {dtype}: appended arena codes differ from the plain version")
        del ka_k, va_k, ka_p, va_p
        layers = cycler(list(range(L)))
        ms = cuda_ms(lambda: k2.decode_attention_arena(q, ka, va, lengths, layers(), **kw))
        call_ms = eager_ms(lambda: k2.decode_attention_arena(q, ka, va, lengths, layers(),
                                                             **kw))
        plain_ms = cuda_ms(lambda: k2.decode_attention_arena_plain(
            q, ka, va, lengths, layers(), new_k=nk, new_v=nv, cos=cos, sin=sin,
            k_scale=ks, v_scale=vs, scale=D ** -0.5, window=None, softcap=None),
            calls=4, rounds=3)
        # Yardstick: SDPA over the dequantized cache (heads expanded, mask by length).
        kd = [(fp8_to_bf16_ftz(ka[i]) * ks.reshape(1, Hk, 1, 1).to(torch.bfloat16))
              .repeat_interleave(Hq // Hk, dim=1) for i in range(4)]
        vd = [(fp8_to_bf16_ftz(va[i]) * vs.reshape(1, Hk, 1, 1).to(torch.bfloat16))
              .repeat_interleave(Hq // Hk, dim=1) for i in range(4)]
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]
        idx = cycler(list(range(4)))

        def sdpa():
            i = idx()
            return F.scaled_dot_product_attention(q4, kd[i], vd[i], attn_mask=mask)

        lib_ms = cuda_ms(sdpa)
        itemsize = ka.element_size()
        nbytes = (2 * int(lengths.sum()) * Hk * D * itemsize + q.numel() * 2 * 2
                  + nk.numel() * 2 * 2 + cos.numel() * 8)
        flops = 4.0 * Hq * D * int(lengths.sum())
        b_ms, b_by = bound_ms(nbytes, flops, bw, peak)
        case = dict(kernel="decode_attention_arena", case=f"B8 Hq32 Hk8 D64 S1024 {dtype}",
                    max_abs_err=err, tol=tol, arena_codes_equal=same_codes, ms=ms,
                    call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        cases.append(case)
        log(case)
        del ka, va, kd, vd

    # ---- K3 at B 1, Sq = Sk in {128, 512}, Hq 32, Hk 8, D 64 ----
    for Sq in (128, 512):
        Bq, Hq, Hk, D = 1, 32, 8, 64
        q = torch.randn((Bq, Sq, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((Bq, Sq, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((Bq, Sq, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        kv_len = Sq - 27
        kv_lens = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        zero = torch.zeros((Bq,), dtype=torch.int32, device=dev)
        got, lse = k3.flash_attention(q, k, v, causal=True, q_offset=zero, kv_lens=kv_lens, return_lse=True)
        ref, ref_lse = k3.flash_fwd_plain(q, k, v, zero, kv_lens, causal=True, window=None,
                                          softcap=None, scale=D ** -0.5)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = 1e-2 * max(1.0, ref.float().abs().max().item())
        check(math.isfinite(err) and err <= tol, f"K3 Sq={Sq}: err {err} > tol {tol}")
        check(math.isfinite(lse_err) and lse_err <= 1e-3, f"K3 Sq={Sq}: lse err {lse_err}")
        ms = cuda_ms(lambda: k3.flash_attention(q, k, v, causal=True, q_offset=zero, kv_lens=kv_lens))
        call_ms = eager_ms(lambda: k3.flash_attention(q, k, v, causal=True, q_offset=zero, kv_lens=kv_lens))
        plain_ms = cuda_ms(lambda: k3.flash_fwd_plain(
            q, k, v, zero, kv_lens, causal=True, window=None, softcap=None,
            scale=D ** -0.5), calls=4, rounds=3)
        qh = q.transpose(1, 2)
        kh = k.transpose(1, 2).repeat_interleave(Hq // Hk, dim=1)
        vh = v.transpose(1, 2).repeat_interleave(Hq // Hk, dim=1)
        pos = torch.arange(Sq, device=dev)
        mask = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len))[None, None]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
        pairs = int(mask.sum())
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 + Bq * Hq * Sq * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * Hq * D * pairs * Bq, bw, peak)
        case = dict(kernel="flash_attention", case=f"B1 Sq=Sk={Sq} Hq32 Hk8 D64 causal "
                    f"kv_len={kv_len}", max_abs_err=err, lse_err=lse_err, tol=tol, ms=ms,
                    call_ms=call_ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        cases.append(case)
        log(case)
    cases += feature_cases(dev, g, log)
    return cases


def feature_cases(dev, g, log):
    """Kernel features off the 1B main path, against the plain versions
    (correctness only): ragged M/N/K for K1, window, softcap, GQA widths and
    head_dim 128 for K2 and K3, q_offset and dead rows for K3."""
    import torch

    from llm_fp8_tpu_torch.kernels import decode_attention as k2
    from llm_fp8_tpu_torch.kernels import flash_attention as k3
    from llm_fp8_tpu_torch.kernels import quant_matmul as k1
    from llm_fp8_tpu_torch.quant import E4M3, quantize, quantize_mx

    cases = []

    def record(kernel, case, err, tol, **extra):
        check(math.isfinite(err) and err <= tol, f"{kernel} {case}: err {err} > tol {tol}")
        c = dict(kernel=kernel, case=case, max_abs_err=err, tol=tol, **extra)
        cases.append(c)
        log(c)

    for M, K, N, mode in ((1, 2048, 3072, "channel"), (5, 2040, 3000, "channel"),
                          (33, 2016, 1000, "mx"), (300, 2048, 2048, "tensor"),
                          (2048, 2048, 3072, "channel")):
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        qt = (quantize_mx(w, E4M3, block_axis=0, flush_subnormal=True) if mode == "mx"
              else quantize(w, E4M3, axes=None if mode == "tensor" else (0,),
                            flush_subnormal=True))
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        for out_dtype in (torch.bfloat16, torch.float32):
            got = k1.quant_matmul(x, qt.qvalue, qt.scale, mode=mode, out_dtype=out_dtype)
            ref = k1.quant_matmul_plain(x, qt.qvalue, qt.scale, mode=mode, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            # bf16 out: two bf16 ulps of the largest output. float32 out: the
            # tensor cores' float32 sums over K ~ 2048 in another order (and
            # not rounded to nearest) than the plain version's, 1e-3 of it.
            tol = (2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-3) * ref.abs().max().item()
            record("quant_matmul", f"M={M} K={K} N={N} {mode} out {out_dtype}", err, tol)

    for (B, Hq, Hk, D, S, dtype, window, softcap) in (
            (3, 8, 8, 64, 700, torch.float8_e4m3fn, 100, 30.0),
            (2, 64, 8, 128, 512, torch.bfloat16, None, None),
            (4, 16, 4, 32, 300, torch.int8, 50, None)):
        integer = dtype == torch.int8
        ks = (torch.rand((Hk,), generator=g, device=dev) + 0.5) * (4 / 127 if integer else 1)
        vs = (torch.rand((Hk,), generator=g, device=dev) + 0.5) * (4 / 127 if integer else 1)
        x = torch.randn((2, B, Hk, S, D), generator=g, device=dev)
        ka = (x if dtype == torch.bfloat16 else
              torch.clamp(x / ks.reshape(1, 1, Hk, 1, 1), -127, 127).round()
              if integer else x / ks.reshape(1, 1, Hk, 1, 1)).to(dtype)
        va = ka.flip(3).clone()
        q = torch.randn((B, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        nk = torch.randn((B, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        nv = torch.randn((B, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        ang = (lengths - 1).float()[:, None] * torch.rand((1, D // 2), generator=g, device=dev)
        cos, sin = torch.cos(ang), torch.sin(ang)
        ka_k, va_k, ka_p, va_p = ka.clone(), va.clone(), ka.clone(), va.clone()
        got, _, _ = k2.decode_attention_arena(q, ka_k, va_k, lengths, 1, new_k=nk, new_v=nv,
                                              rope_cos_sin=(cos, sin), k_scale=ks,
                                              v_scale=vs, window=window, softcap=softcap)
        ref = k2.decode_attention_arena_plain(q, ka_p, va_p, lengths, 1, new_k=nk, new_v=nv,
                                              cos=cos, sin=sin, k_scale=ks, v_scale=vs,
                                              scale=D ** -0.5, window=window, softcap=softcap)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        same = bool(torch.equal(ka_k.view(torch.uint8), ka_p.view(torch.uint8))
                    and torch.equal(va_k.view(torch.uint8), va_p.view(torch.uint8)))
        check(same, f"K2 features {dtype}: appended codes differ")
        record("decode_attention_arena", f"B{B} Hq{Hq} Hk{Hk} D{D} S{S} {dtype} "
               f"window {window} softcap {softcap}", err,
               1e-2 * max(1.0, ref.float().abs().max().item()), arena_codes_equal=same)

    for (B, Sq, Sk, Hq, Hk, D, causal, window, softcap, q_off, kv) in (
            (2, 100, 300, 16, 4, 128, True, 64, 20.0, [200, 150], [300, 260]),
            (2, 70, 70, 8, 8, 32, False, None, None, [0, 0], [70, 33]),
            (2, 8, 40, 4, 2, 64, True, 4, None, [0, 30], [40, 20])):  # batch 1: dead rows
        q = torch.randn((B, Sq, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((B, Sk, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, Sk, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
        kl = torch.tensor(kv, dtype=torch.int32, device=dev)
        cfg = dict(causal=causal, window=window, softcap=softcap, scale=D ** -0.5)
        got, lse = k3.flash_attention(q, k, v, q_offset=qo, kv_lens=kl, return_lse=True, **cfg)
        ref, ref_lse = k3.flash_fwd_plain(q, k, v, qo, kl, **cfg)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        live = torch.isfinite(ref_lse)
        check(bool(torch.equal(live, torch.isfinite(lse))), "K3 features: dead rows differ")
        lse_err = (lse[live] - ref_lse[live]).abs().max().item() if live.any() else 0.0
        check(lse_err <= 1e-3, f"K3 features: lse err {lse_err}")
        record("flash_attention", f"B{B} Sq{Sq} Sk{Sk} Hq{Hq} Hk{Hk} D{D} causal {causal} "
               f"window {window} softcap {softcap}", err,
               1e-2 * max(1.0, ref.float().abs().max().item()), lse_err=lse_err,
               dead_rows=int((~live).sum()))
    return cases


# --------------------------------------------------------------------------
# phase 3: the slice on the card against the CPU
# --------------------------------------------------------------------------


def slice_check(dev, log):
    import dataclasses

    import torch

    from llm_fp8_tpu_torch.models import forward, forward_decode_arena, get_config
    from llm_fp8_tpu_torch.models.llama import init_params, quantize_params
    from llm_fp8_tpu_torch.quant import LAYERWISE, QTensor

    cfg = dataclasses.replace(get_config("llama-3.2-1b"), num_layers=2)
    params = quantize_params(init_params(cfg, device=dev, seed=7), LAYERWISE)

    def to_cpu(t):
        if isinstance(t, QTensor):
            return t.to("cpu")
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.cpu()

    cpu_params = to_cpu(params)
    n, bucket, S = 40, 64, 128
    rng = torch.Generator().manual_seed(3)
    prompt = torch.zeros((1, bucket), dtype=torch.int64)
    prompt[0, :n] = torch.randint(1, cfg.vocab_size, (n,), generator=rng)
    L, Hk, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    tol = 0.06  # bf16 activations, other sum orders, bf16-rounded logits on the card
    errs, tokens = [], []
    runs = {}
    for name, p, d in (("cuda", params, dev), ("cpu", cpu_params, torch.device("cpu"))):
        lg, (k, v) = forward(p, prompt.to(d), cfg, kv_lens=torch.tensor([n], device=d),
                             return_kv=True)
        ka = torch.zeros((L, 1, Hk, S, Dh), dtype=torch.float8_e4m3fn, device=d)
        va = torch.zeros_like(ka)
        ka[:, 0, :, :bucket] = k[:, 0].permute(0, 2, 1, 3).float().clamp(-448, 448).to(ka.dtype)
        va[:, 0, :, :bucket] = v[:, 0].permute(0, 2, 1, 3).float().clamp(-448, 448).to(va.dtype)
        runs[name] = [lg[0, n - 1].float().cpu()], (p, ka, va, d)
    tok = int(torch.argmax(runs["cpu"][0][0]))
    for step in range(2):
        for name in ("cuda", "cpu"):
            p, ka, va, d = runs[name][1]
            lg, _, _ = forward_decode_arena(
                p, torch.tensor([[tok]], device=d), cfg, ka, va,
                torch.tensor([n + step], dtype=torch.int32, device=d))
            runs[name][0].append(lg[0, 0].float().cpu())
        tok = int(torch.argmax(runs["cpu"][0][-1]))
        tokens.append(tok)
    # The generic bf16 KVCache path (bf16 KV in the engine): prefill into the
    # cache, then one decode step, on both devices.
    from llm_fp8_tpu_torch.models.llama import init_kv_cache

    for name, p, d in (("cuda", params, dev), ("cpu", cpu_params, torch.device("cpu"))):
        cache = init_kv_cache(cfg, 1, S, device=d)
        lg, cache = forward(p, prompt.to(d), cfg, cache=cache, start_pos=0,
                            kv_lens=torch.tensor([n], device=d))
        lg2, _ = forward(p, torch.tensor([[tokens[0]]], device=d), cfg, cache=cache,
                         start_pos=torch.tensor([n], device=d),
                         kv_lens=torch.tensor([n + 1], device=d))
        runs[name][0].extend([lg[0, n - 1].float().cpu(), lg2[0, 0].float().cpu()])
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        check(bool(torch.isfinite(a).all()), "slice: non-finite logits on the card")
        errs.append((a - b).abs().max().item())
    res = dict(config="llama-3.2-1b, 2 layers, LAYERWISE fp8; fp8 arena (prefill + 2 "
               "decode steps), then bf16 KVCache (prefill + 1 decode step)",
               steps=len(errs), logits_max_abs_err=max(errs), per_step=errs, tol=tol,
               logits_max_abs=max(float(x.abs().max()) for x in runs["cpu"][0]))
    log(res)
    check(max(errs) <= tol, f"slice: logits err {max(errs)} > tol {tol}")
    return res


# --------------------------------------------------------------------------
# phase 4: serving through the engine
# --------------------------------------------------------------------------


def serving(dev, num_layers, card, log):
    import dataclasses

    import numpy as np
    import torch

    from llm_fp8_tpu_torch import kernels
    from llm_fp8_tpu_torch.models import get_config
    from llm_fp8_tpu_torch.models.llama import init_params, quantize_params
    from llm_fp8_tpu_torch.quant import LAYERWISE
    from llm_fp8_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    class CheckedEngine(Engine):
        """Engine that also records whether every logits row was finite, and
        the host time of prefills and decode bursts (each ends in a sync)."""

        finite = None
        prefill_s = decode_s = 0.0
        decode_steps = 0

        def _note(self, logits):
            ok = torch.isfinite(logits).all()
            self.finite = ok if self.finite is None else (self.finite & ok)

        def _decode_step(self, toks, lens):
            logits, g = super()._decode_step(toks, lens)
            self._note(logits)
            return logits, g

        def _run_prefill(self, padded, true_len, slot):
            t0 = time.perf_counter()
            last = super()._run_prefill(padded, true_len, slot)
            self._note(last)
            torch.cuda.synchronize()
            self.prefill_s += time.perf_counter() - t0
            return last

        def _run_decode_burst(self, toks, lens, steps):
            t0 = time.perf_counter()
            out = super()._run_decode_burst(toks, lens, steps)  # reads back: synced
            self.decode_s += time.perf_counter() - t0
            self.decode_steps += steps
            return out

    cfg = dataclasses.replace(get_config("llama-3.2-1b"), num_layers=num_layers)
    t0 = time.perf_counter()
    params = quantize_params(init_params(cfg, device=dev, seed=0), LAYERWISE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    results = {}
    for kv, n_req in (("fp8", 8), ("int8", 2)):
        ecfg = EngineConfig(max_slots=8, max_seq_len=1024, prefill_buckets=(128, 256),
                            kv_dtype=kv)
        warm = CheckedEngine(params, cfg, ecfg, device=dev)
        warm.add_request(np.arange(1, 17, dtype=np.int32), SamplingParams(max_new_tokens=4))
        warm.run()
        del warm
        eng = CheckedEngine(params, cfg, ecfg, device=dev)
        prompts = [rng.randint(1, cfg.vocab_size, rng.randint(100, 251)).astype(np.int32)
                   for _ in range(n_req)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=32)) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for r in reqs:
            check(r.done and r.error is None, f"serve {kv}: request {r.request_id} {r.error}")
            check(len(r.output) == 32, f"serve {kv}: {len(r.output)} tokens, not 32")
            check(all(0 <= t < cfg.vocab_size for t in r.output), f"serve {kv}: bad token")
        check(eng.finite is not None and bool(eng.finite), f"serve {kv}: non-finite logits")
        for name, c in counts.items():
            check(c > 0, f"serve {kv}: kernel {name} was launched {c} times")
        if kv == "int8":
            check(bool(torch.isfinite(eng._kscales).all() and (eng._kscales > 0).all()),
                  "serve int8: bad calibrated scales")
        ttfts = sorted(r.ttft for r in reqs)
        res = dict(card=card, kv_dtype=kv, requests=n_req, layers=num_layers,
                   prompt_lens=[len(p) for p in prompts], generated=32 * n_req,
                   wall_s=wall, tokens_per_s=32 * n_req / wall,
                   ttft_p50_s=ttfts[len(ttfts) // 2],
                   peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   launches=counts, init_s=init_s, prefill_s=eng.prefill_s,
                   decode_s=eng.decode_s, decode_steps=eng.decode_steps,
                   decode_step_ms=1e3 * eng.decode_s / max(eng.decode_steps, 1))
        if kv == "fp8":
            res["profile"] = profile_run(CheckedEngine, params, cfg, ecfg, prompts, dev)
        log(res)
        results[kv] = res
        del eng
    return results


def profile_run(engine_cls, params, cfg, ecfg, prompts, dev):
    """The same fp8 serving run under torch.profiler: device (kernel) time
    against wall time, and the kernels that take most of it. A separate run,
    so the profiler's overhead stays out of the numbers above."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llm_fp8_tpu_torch.serving import SamplingParams

    eng = engine_cls(params, cfg, ecfg, device=dev)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=32))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return dict(wall_s=wall, device_s=device_us / 1e6,
                device_busy_share=device_us / 1e6 / wall,
                top=[dict(name=e.key[:90], calls=e.count,
                          device_ms=e.self_device_time_total / 1e3) for e in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,slice,serve",
                    help="comma list of kernels, slice, serve")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the per-case JSON report and the nvcc logs")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    if not (ROOT / "llm_fp8_tpu_torch").is_dir():
        print("chip_smoke: the llm_fp8_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    from llm_fp8_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    bw, peak = peaks(name)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"peaks {bw / 1e12:.2f} TB/s, {peak / 1e12:.0f} TFLOP/s bf16", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})",
          flush=True)

    report = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=built)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        for log_file in _build.BUILD_DIR.glob("*.log"):  # nvcc -Xptxas -v output
            (args.out / f"nvcc_{log_file.name}").write_text(log_file.read_text())

    def save_report():
        if args.out is not None:
            (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    def log(obj):
        print(json.dumps(obj, default=str), flush=True)

    try:
        if "kernels" in phases:
            report["kernels"] = kernel_cases(dev, bw, peak, log)
        if "slice" in phases:
            report["slice"] = slice_check(dev, log)
        if "serve" in phases:
            report["serve"] = serving(dev, 16, card, log)
    except SmokeFailure as e:
        save_report()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    save_report()

    if phases != {"kernels", "slice", "serve"}:
        print(f"chip_smoke: partial run ({args.phases}); no result line", flush=True)
        return 0
    launches = report["serve"]["fp8"]["launches"]
    pick = {"quant_matmul": "w_gate_up M=8 channel e4m3",
            "decode_attention_arena": "B8 Hq32 Hk8 D64 S1024 torch.float8_e4m3fn",
            "flash_attention": "B1 Sq=Sk=128"}
    meta = {"quant_matmul": ("csrc/quant_matmul.cu", "llm_fp8_tpu/kernels/quant_matmul.py:126"),
            "decode_attention_arena": ("csrc/decode_attention.cu",
                                       "llm_fp8_tpu/kernels/decode_attention.py:300"),
            "flash_attention": ("csrc/flash_attention.cu",
                                "llm_fp8_tpu/kernels/flash_attention.py:475")}
    line = []
    for kname, prefix in pick.items():
        c = next(c for c in report["kernels"]
                 if c["kernel"] == kname and c["case"].startswith(prefix))
        src, repl = meta[kname]
        line.append(dict(name=kname, route="cuda", source=f"llm_fp8_tpu_torch/{src}",
                         replaces=repl, launches=launches[kname],
                         max_abs_err=c["max_abs_err"], ms=c["ms"], plain_ms=c["plain_ms"],
                         bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                         library_ms=c["library_ms"], case=c["case"]))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
