"""Time design alternatives of two kernels on the card, in one process.

``k1-splits``: K1's decode kernel at M = 8 on the four Llama-3.2-1B
projections (e4m3, channel and MX scales) at each split count its cluster
takes (1, 2, 4, 8), beside ``torch.matmul`` on the bf16 dequantized weight and
the split count :func:`~llm_fp8_tpu_torch.kernels.quant_matmul.split_plan`
picks. Weight copies rotate past the L2 cache, as decode finds them cold.

``k1-merge``: the same kernel with its splits merged the other way the
design allowed: each split block writes its float32 partial to device
memory and the last block of a column tile to arrive (a counter it resets)
sums them in split order, with no cluster; beside the shipped cluster
merge at each split count, both outputs compared bit for bit.

``k7-exp``: K7 built with four ways of computing p: as shipped (the log2
domain, one FFMA and ``ex2`` a score) and three in the plain version's
natural domain (``s − m`` with s rounded after each product, then ``expf``,
``ex2`` of ``(s − m) · log2 e`` or ``exp2f`` of it). For each: the worst row
and the rows beyond 1 and 2 bf16 ulps of ``flash_fp8_plain`` on both routes,
and the device time of both routes, at the 8192-token prefill, the training
shape and the 8-slot decode.

``k3k6-bits DIR``: K3 and K6 (bf16) built from another checkout's
``csrc`` directory ``DIR`` beside the repo's, on the same inputs at head dims
32, 64 and 128 (plain, window and softcap, ALiBi and dropout): whether the
outputs (out and lse; dq, dk and dv) are equal bit for bit, and the device
time of both builds in turns (old, new, new, old), so that a change to the
kernels' sources (a new head dim, a new mask) can be shown to leave the
existing instances as they were. A build older than the segment ids and the
chunk is called without those arguments.

``k3k6-f32 DIR``: K3's and K6's float32 instances built from another
checkout's ``csrc`` directory ``DIR`` beside the repo's, on the same inputs
at every case of ``chip_smoke.py``'s ``ZOO_K3_CASES``, ``ENC_F32_CASES`` and
``ZOO_K6_CASES``: each build's worst row against the plain version (in the
units of ``F32_ROW_TOL`` and ``F32_GRAD_TOL``) and the device times of both
builds in turns (old, new, new, old); where the dKV plan splits the GQA
group, the repo's build is also timed with the walk in one slice. A build
from before the group split is called with one slice and no sum pass.

``k6-f32-slices``: K6's float32 dKV kernel (and its sum pass) at every
slice count that divides the GQA group, at SantaCoder's, a GQA-8 and
Falcon-7B's training shapes, beside the count ``dkv_slices`` plans.

    python -m llm_fp8_tpu_torch.scripts.kernel_variants [k1-splits] [k1-merge] [k7-exp]
    python -m llm_fp8_tpu_torch.scripts.kernel_variants k3k6-bits OLD_CHECKOUT/llm_fp8_tpu_torch/csrc
    python -m llm_fp8_tpu_torch.scripts.kernel_variants k3k6-f32 OLD_CHECKOUT/llm_fp8_tpu_torch/csrc
    python -m llm_fp8_tpu_torch.scripts.kernel_variants k6-f32-slices

Needs a CUDA card and ``nvcc``. Times are device times of calls captured in
a CUDA graph. Prints one JSON object per case.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import flash_attention as k7
from ..kernels import quant_matmul as k1
from ..kernels._common import W_KINDS, num_sms
from ..quant import E4M3, quantize, quantize_mx

__all__ = ["main"]


def _graph_ms(fn, calls: int = 20, rounds: int = 3) -> float:
    """Device ms of one call: ``calls`` calls in a CUDA graph, replayed
    ``rounds`` times between CUDA events, the median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _cycle(items):
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]
    return nxt


def k1_splits(dev: torch.device) -> None:
    lib = _build.library("quant_matmul")
    g = torch.Generator(device=dev).manual_seed(1234)
    shapes = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w_gate_up": (2048, 16384),
              "w_down": (8192, 2048)}
    M = 8
    for name, (K, N) in shapes.items():
        for mode in ("channel", "mx"):
            w = torch.randn((K, N), generator=g, device=dev) * 0.02
            qt = (quantize_mx(w, E4M3, block_axis=0, flush_subnormal=True) if mode == "mx"
                  else quantize(w, E4M3, axes=(0,), flush_subnormal=True))
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            ref = k1.quant_matmul_plain(x, qt.qvalue, qt.scale, mode=mode).float()
            scale = qt.scale.reshape(-1).to(
                torch.bfloat16 if mode == "mx" else torch.float32).contiguous()
            copies = max(1, math.ceil(200e6 / (K * N)))
            nw = _cycle([qt.qvalue.clone() for _ in range(copies)])
            k_tiles = -(-K // 32)
            row = {"case": f"{name} M={M} {mode} e4m3",
                   "plan": list(k1.split_plan(M, N, K, num_sms(dev)))}
            for splits in (1, 2, 4, 8):
                per = -(-k_tiles // splits)

                def run(wq, splits=splits, per=per):
                    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                    p = ctypes.c_void_p
                    err = lib.qmm_launch(p(x.data_ptr()), p(wq.data_ptr()), p(scale.data_ptr()),
                                         p(out.data_ptr()), M, N, K, W_KINDS[qt.qvalue.dtype],
                                         2 if mode == "mx" else 1, 0, splits, per,
                                         p(torch.cuda.current_stream().cuda_stream))
                    _build.check(lib, err, "quant_matmul")
                    return out
                err = (run(qt.qvalue).float() - ref).abs().max().item()
                row[f"splits_{splits}_us"] = _graph_ms(lambda: run(nw())) * 1e3
                row[f"splits_{splits}_ok"] = err <= 2.0 ** -7 * ref.abs().max().item()
            nd = _cycle([qt.dequantize(torch.bfloat16) for _ in range(max(1, copies // 2))])
            row["torch_matmul_us"] = _graph_ms(lambda: torch.matmul(x, nd())) * 1e3
            print(json.dumps(row), flush=True)


# K1's decode kernel with a merge through device memory: the cluster's
# mbarrier set-up goes, each block of a split column tile writes its sums to
# a partial and the last to arrive sums the partials in split order.
_COUNTER_GLOBALS = r"""
__device__ float g_partials[8 * 64 * 16384];  // [tile][split][rows][64]
__device__ unsigned g_arrived[4096];          // per tile; the last block resets it
"""
_COUNTER_MERGE = r"""
  __syncthreads();
  const int tile = blockIdx.z * gridDim.y + blockIdx.y;
  float* part = g_partials + static_cast<size_t>(tile) * splits * RR * kDCols;
  __shared__ unsigned last_block;
  if (splits > 1) {
    for (int i = threadIdx.x; i < RR * kDCols; i += kDThreads)
      part[blockIdx.x * RR * kDCols + i] = red[(i / kDCols) * kDRedPitch + i % kDCols];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last_block = atomicAdd(&g_arrived[tile], 1u) == static_cast<unsigned>(splits - 1);
      if (last_block) g_arrived[tile] = 0;
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
  }
  for (int i = threadIdx.x; i < RR * kDCols; i += kDThreads) {
    const int r = i / kDCols, c = i % kDCols, m = m0 + r, n = n0 + c;
    float v = red[r * kDRedPitch + c];
    if (splits > 1) {
      v = __ldcg(part + i);
      for (int q = 1; q < splits; ++q) v += __ldcg(part + q * RR * kDCols + i);
    }
    if (m >= M || n >= N) continue;
    if (mode == kModeTensor) v *= static_cast<const float*>(scale)[0];
    else if (mode == kModeChannel) v *= static_cast<const float*>(scale)[n];
    const size_t o = static_cast<size_t>(m) * N + n;
    if (out_f32) static_cast<float*>(out)[o] = v;
    else static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}
"""


def _k1_counter_variant() -> str:
    src = (_build.CSRC / "quant_matmul.cu").read_text()
    start = src.index("  const uint32_t recv_bar = hopper::smem_u32(smem + St::BAR);")
    end = src.index('    asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n  }\n',
                    start)
    end = src.index("  }\n", end + 10) + 4
    src = src[:start] + src[end:]
    a = src.index("  __syncthreads();\n  const int share = RR * kDCols / splits")
    b = src.index("\n}\n", a) + 3
    src = src[:a] + _COUNTER_MERGE.lstrip("\n") + src[b:]
    if src.count("attr[0].val.clusterDim.x = splits;") != 1:
        raise RuntimeError("K1's decode launcher has changed: update this script")
    src = src.replace("attr[0].val.clusterDim.x = splits;", "attr[0].val.clusterDim.x = 1;")
    k = src.index("template <int MT, int KIND, bool MX>\n__global__")
    return src[:k] + _COUNTER_GLOBALS.lstrip("\n") + "\n" + src[k:]


def k1_merge(dev: torch.device) -> None:
    shipped = _build.library("quant_matmul")
    libs = {"cluster": shipped, "counter": _build_variants(
        {"counter": _k1_counter_variant()}, "quant_matmul")["counter"]}
    g = torch.Generator(device=dev).manual_seed(1234)
    shapes = {"wqkv": (2048, 3072), "wo": (2048, 2048), "w_gate_up": (2048, 16384),
              "w_down": (8192, 2048)}
    M = 8
    for name, (K, N) in shapes.items():
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        qt = quantize(w, E4M3, axes=(0,), flush_subnormal=True)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        scale = qt.scale.reshape(-1).float().contiguous()
        copies = max(1, math.ceil(200e6 / (K * N)))
        nw = _cycle([qt.qvalue.clone() for _ in range(copies)])
        k_tiles = -(-K // 32)
        row = {"case": f"{name} M={M} channel e4m3",
               "plan": list(k1.split_plan(M, N, K, num_sms(dev)))}
        for splits in (2, 4, 8):
            per = -(-k_tiles // splits)
            outs = {}
            for tag, lib in libs.items():
                def run(wq, lib=lib, splits=splits, per=per):
                    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                    p = ctypes.c_void_p
                    err = lib.qmm_launch(p(x.data_ptr()), p(wq.data_ptr()), p(scale.data_ptr()),
                                         p(out.data_ptr()), M, N, K, W_KINDS[qt.qvalue.dtype],
                                         1, 0, splits, per,
                                         p(torch.cuda.current_stream().cuda_stream))
                    _build.check(lib, err, "quant_matmul")
                    return out
                outs[tag] = (run(qt.qvalue), run(qt.qvalue))
                row[f"{tag}_{splits}_us"] = [_graph_ms(lambda: run(nw())) * 1e3
                                             for _ in range(2)]
            row[f"same_bits_{splits}"] = all(
                torch.equal(a.view(torch.int16), outs["cluster"][0].view(torch.int16))
                for pair in outs.values() for a in pair)
        print(json.dumps(row), flush=True)


# K7's softmax in the plain version's natural domain: the kernels call key(),
# max2() and p() of this struct, and EXP replaces the rescale's ex2.
_NATURAL = r"""struct Softmax2 {
  float scale, qkd, softcap;
  bool monotone;
  __device__ Softmax2(float scale_, float qkd_, float softcap_)
      : scale(scale_), qkd(qkd_), softcap(softcap_),
        monotone(softcap_ <= 0.0f && scale_ > 0.0f && qkd_ > 0.0f) {}
  __device__ __forceinline__ float scaled(float a) const {
    return __fmul_rn(__fmul_rn(a, scale), qkd);
  }
  __device__ __forceinline__ float key(float a) const {
    if (monotone) return a;
    const float x = scaled(a);
    return softcap > 0.0f ? softcap * tanhf(x / softcap) : x;
  }
  __device__ __forceinline__ float max2(float kmax) const {
    return monotone ? scaled(kmax) : kmax;
  }
  __device__ __forceinline__ float p(float k, float m) const {
    return EXP((monotone ? scaled(k) : k) - (m == -INFINITY ? INFINITY : m));
  }
};
"""
_EXPS = {"expf": "expf(x)",
         "ex2_of_s_minus_m": "hopper::fast_exp2((x) * 1.4426950408889634f)",
         "exp2f_of_s_minus_m": "exp2f((x) * 1.4426950408889634f)"}


def _k7_variant(exp: str) -> str:
    src = (_build.CSRC / "flash_attention_fp8.cu").read_text()
    a = src.index("struct Softmax2 {")
    b = src.index("};\n", a) + 3
    src = src[:a] + f"#define EXP(x) {exp}\n" + _NATURAL + src[b:]
    n = src.count("fast_exp2(m[r] - m_next)")
    if n != 2:
        raise RuntimeError(f"K7's rescale has changed ({n} sites): update this script")
    src = src.replace("hopper::fast_exp2(m[r] - m_next)", "EXP(m[r] - m_next)")
    return src.replace("fast_exp2(m[r] - m_next)", "EXP(m[r] - m_next)")


def _build_variants(variants: dict, lib_name: str = "flash_attention_fp8",
                    headers: Path = _build.CSRC) -> dict:
    """Each {name: source} of ``lib_name`` built beside the headers of
    ``headers`` (the repo's by default) and loaded."""
    tmp = Path(tempfile.mkdtemp())
    procs = {}
    for name, src in variants.items():
        d = tmp / name
        d.mkdir()
        for h in _build._HEADERS:
            if (headers / h).exists():
                shutil.copy(headers / h, d / h)
        (d / f"{lib_name}.cu").write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
             str(d / f"{lib_name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), d / "lib.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        for fn, argtypes in _build._SIGNATURES[lib_name].items():
            if not hasattr(lib, fn):  # an older build without this launcher
                continue
            f = getattr(lib, fn)
            f.restype, f.argtypes = ctypes.c_int, argtypes
        libs[name] = lib
    shutil.rmtree(tmp, ignore_errors=True)
    return libs


def _row_ulps(got, ref):
    err = (got.float() - ref.float()).abs().amax(dim=-1)
    top = ref.float().abs().amax(dim=-1)
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
    return torch.where(err > 0, err / torch.where(top > 0, ulp, torch.ones_like(ulp)),
                       torch.zeros_like(err))


def k7_exp(dev: torch.device) -> None:
    shipped = _build.library("flash_attention_fp8")
    libs = {"shipped_log2_ex2": shipped}
    libs.update(_build_variants({n: _k7_variant(e) for n, e in _EXPS.items()}))
    g = torch.Generator(device=dev).manual_seed(1357)
    cases = (("prefill B1 Sq=Sk=8192 causal kv_len 8184", 1, 8192, 8192, [0], [8184], 1024),
             ("train B8 S512 causal", 8, 512, 512, [0] * 8, [512] * 8, None),
             ("decode B8 Sq1 Sk1024", 8, 1, 1024, None, [1, 37, 200, 511, 512, 640, 1000, 1024],
              None))
    Hq, Hk, D = 32, 8, 64
    try:
        for name, B, Sq, Sk, q_off, kv, chunk in cases:
            codes, descale = [], []
            for S, H in ((Sq, Hq), (Sk, Hk), (Sk, Hk)):
                x = torch.randn((B, S, H, D), generator=g, device=dev)
                xg = x.reshape(B, S, Hk, H // Hk, D)
                d = xg.abs().amax(dim=(1, 3, 4)) / 448.0
                codes.append((xg / d[:, None, :, None, None]).to(torch.float8_e4m3fn)
                             .reshape(B, S, H, D))
                descale.append(d)
            descale = torch.stack(descale)
            kl = torch.tensor(kv, dtype=torch.int32, device=dev)
            qo = kl - 1 if q_off is None else torch.tensor(q_off, dtype=torch.int32, device=dev)
            cfg = dict(causal=True, window=None, softcap=None, scale=D ** -0.5,
                       block_k=k7.auto_block(Sk), out_dtype=torch.bfloat16)

            def call(native):
                return k7.flash_attention_fp8(*codes, q_descale=descale[0],
                                              k_descale=descale[1], v_descale=descale[2],
                                              q_offset=qo, kv_lens=kl, fp8_native=native, **cfg)
            ch = chunk or Sq
            ref = torch.cat([k7.flash_fp8_plain(codes[0][:, i:i + ch], codes[1], codes[2],
                                                descale, qo + i, kl, **cfg)
                             for i in range(0, Sq, ch)], dim=1)
            row = {"case": name}
            reps = dict(calls=5) if Sq >= 8192 else {}
            for tag, lib in libs.items():
                _build._LIBS["flash_attention_fp8"] = lib
                for native in (True, False):
                    route = "native" if native else "dequant"
                    u = _row_ulps(call(native), ref)
                    row[f"{tag} {route}"] = dict(
                        worst_ulps=u.max().item(), rows_beyond_1_ulp=int((u > 1).sum()),
                        rows_beyond_2_ulps=int((u > 2).sum()), rows=u.numel(),
                        us=_graph_ms(lambda: call(native), **reps) * 1e3)
            print(json.dumps(row), flush=True)
    finally:
        _build._LIBS["flash_attention_fp8"] = shipped


#: k3k6-bits cases: name, B, S, Hq, Hk, D, window, softcap, ALiBi, dropout.
_BITS_CASES = (
    ("train B8 S512 Hq32 Hk8 D64", 8, 512, 32, 8, 64, None, None, False, 0.0),
    ("prefill B1 S8192 Hq32 Hk8 D64", 1, 8192, 32, 8, 64, None, None, False, 0.0),
    ("B2 S1024 Hq16 Hk4 D128 window 300 softcap 30", 2, 1024, 16, 4, 128, 300, 30.0, False,
     0.0),
    ("B2 S300 Hq8 Hk8 D32 window 50", 2, 300, 8, 8, 32, 50, None, False, 0.0),
    ("B2 S1024 Hq40 Hk40 D128 alibi", 2, 1024, 40, 40, 128, None, None, True, 0.0),
    ("B1 S4096 Hq40 Hk40 D128 alibi", 1, 4096, 40, 40, 128, None, None, True, 0.0),
    ("B8 S512 Hq32 Hk8 D64 dropout 0.1", 8, 512, 32, 8, 64, None, None, False, 0.1),
)


class _WithoutMasks:
    """An older K3 or K6 build whose launchers predate segment ids and the
    chunk: the wrappers' calls reach it with those three arguments (null
    ids, chunk 0) left out."""

    #: launcher → positions of q_seg, kv_seg and chunk in its arguments
    MASK_ARGS = {"flash_fwd_launch": (8, 9, 20), "flash_bwd_dkv_launch": (11, 12, 23),
                 "flash_bwd_dq_launch": (11, 12, 23)}

    def __init__(self, lib, name):
        self._lib = lib
        for fn, argtypes in _build._SIGNATURES[name].items():
            skip = self.MASK_ARGS[fn]
            getattr(lib, fn).argtypes = [a for i, a in enumerate(argtypes) if i not in skip]

    def __getattr__(self, fn):
        if fn not in self.MASK_ARGS:
            return getattr(self._lib, fn)
        skip = self.MASK_ARGS[fn]
        return lambda *args: getattr(self._lib, fn)(
            *(a for i, a in enumerate(args) if i not in skip))


def k3k6_bits(dev: torch.device, old: Path) -> None:
    from ..kernels import flash_attention as k3
    from ..kernels import flash_attention_bwd as k6
    from ..ops.attention import default_alibi_slopes

    names = ("flash_attention", "flash_attention_bwd")
    new = {n: _build.library(n) for n in names}
    olds = {}
    for n in names:
        src = (old / f"{n}.cu").read_text()
        lib = _build_variants({"old": src}, n, old)["old"]
        olds[n] = lib if "q_seg" in src else _WithoutMasks(lib, n)
    g = torch.Generator(device=dev).manual_seed(97)

    def use(libs):
        for n in names:
            _build._LIBS[n] = libs[n]

    try:
        for name, B, S, Hq, Hk, D, window, softcap, alibi, rate in _BITS_CASES:
            q, do = (torch.randn((B, S, Hq, D), generator=g, device=dev).to(torch.bfloat16)
                     for _ in range(2))
            k, v = (torch.randn((B, S, Hk, D), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            qo = torch.zeros((B,), dtype=torch.int32, device=dev)
            kl = torch.full((B,), S, dtype=torch.int32, device=dev)
            kl[-1] = S - 37
            slopes = default_alibi_slopes(Hq, dev) if alibi else None
            cfg = dict(causal=True, window=window, softcap=softcap, scale=D ** -0.5)
            drop = dict(dropout_p=rate, dropout_seed=11)

            def fwd():
                return k3.flash_attention(q, k, v, q_offset=qo, kv_lens=kl, return_lse=True,
                                          alibi_slopes=slopes, **cfg, **drop)

            outs, times = {}, {}
            for tag, libs in (("old", olds), ("new", new)):
                use(libs)
                out, lse = fwd()
                al = None if slopes is None else slopes[None].expand(B, Hq).contiguous()
                grads = k6.flash_attention_bwd(q, k, v, out, lse, do, q_offset=qo, kv_lens=kl,
                                               alibi=al, **cfg, **drop)
                outs[tag] = (out, lse, *grads)

                def bwd(out=out, lse=lse, al=al):
                    return k6.flash_attention_bwd(q, k, v, out, lse, do, q_offset=qo,
                                                  kv_lens=kl, alibi=al, **cfg, **drop)
                times[tag] = (fwd, bwd)
            torch.cuda.synchronize()
            equal = {what: bool(torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                                            else a.view(torch.int16),
                                            b.view(torch.int32) if b.dtype == torch.float32
                                            else b.view(torch.int16)))
                     for what, a, b in zip(("out", "lse", "dq", "dk", "dv"), outs["old"],
                                           outs["new"])}
            us = {f"{tag} {part}": [] for tag in ("old", "new") for part in ("fwd", "bwd")}
            for tag in ("old", "new", "new", "old"):
                use(olds if tag == "old" else new)
                for part, fn in zip(("fwd", "bwd"), times[tag]):
                    us[f"{tag} {part}"].append(_graph_ms(fn, calls=5) * 1e3)
            print(json.dumps({"case": name, "bits_equal": equal, "us": us}), flush=True)
            if not all(equal.values()):
                raise SystemExit(f"k3k6-bits {name}: outputs differ from the old build: {equal}")
    finally:
        use(new)


class _F32BwdBeforeSlices:
    """K6's float32 build from before the GQA group split: its dKV launcher
    takes no slice count and writes dk and dv itself (the wrappers reach it
    with the plan at one slice, so they call no sum pass)."""

    SLICES_ARG = 17  # nslices' position in the dKV launcher's arguments

    def __init__(self, lib):
        self._lib = lib
        sig = _build._SIGNATURES["flash_attention_bwd_f32"]["flash_bwd_f32_dkv_launch"]
        lib.flash_bwd_f32_dkv_launch.argtypes = [a for i, a in enumerate(sig)
                                                 if i != self.SLICES_ARG]

    def __getattr__(self, fn):
        if fn != "flash_bwd_f32_dkv_launch":
            return getattr(self._lib, fn)
        return lambda *args: self._lib.flash_bwd_f32_dkv_launch(
            *(a for i, a in enumerate(args) if i != self.SLICES_ARG))


def k3k6_f32(dev: torch.device, old: Path) -> None:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    from ..kernels import flash_attention as k3
    from ..kernels import flash_attention_bwd as k6
    from ..kernels._common import pad_head_dim
    from ..ops.attention import default_alibi_slopes

    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("flash_attention_f32", "flash_attention_bwd_f32")
    new = {n: _build.library(n) for n in names}
    olds = {n: _build_variants({"old": (old / f"{n}.cu").read_text()}, n, old)["old"]
            for n in names}
    old_slices = hasattr(olds["flash_attention_bwd_f32"], "flash_bwd_f32_dkv_sum_launch")
    if not old_slices:
        olds["flash_attention_bwd_f32"] = _F32BwdBeforeSlices(olds["flash_attention_bwd_f32"])
    plan = k6.dkv_slices
    print(json.dumps({"card": cs.nvidia_smi(), "old": str(old),
                      "old_splits_the_group": old_slices}), flush=True)

    def use(tag):
        for n in names:
            _build._LIBS[n] = (olds if tag == "old" else new)[n]
        one = tag == "new, one slice" or (tag == "old" and not old_slices)
        k6.dkv_slices = (lambda *a: 1) if one else plan

    def turns(tags, fn):
        us = {tag: [] for tag in tags}
        for tag in tags + tags[::-1]:
            use(tag)
            us[tag].append(_graph_ms(fn, calls=5) * 1e3)
        return us

    g = torch.Generator(device=dev).manual_seed(4321)
    try:
        fwd_cases = [(name, B, Sq, Sk, Hq, Hk, D, qo, kv, al, sc, True)
                     for name, B, Sq, Sk, Hq, Hk, D, qo, kv, al, sc in cs.ZOO_K3_CASES]
        fwd_cases += [(name, B, S, S, H, H, D, [0] * B, kv or [S] * B, False, None, False)
                      for name, B, S, H, D, kv in cs.ENC_F32_CASES]
        for name, B, Sq, Sk, Hq, Hk, D, q_off, kv, alibi, scale, causal in fwd_cases:
            Dp = D if D in k3.F32_HEAD_DIMS else 32
            q, k, v = (pad_head_dim(torch.randn(s, generator=g, device=dev), Dp)
                       for s in ((B, Sq, Hq, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))
            qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
            kl = torch.tensor(kv, dtype=torch.int32, device=dev)
            al = default_alibi_slopes(Hq, dev)[None].expand(B, Hq).contiguous() if alibi else None
            cfg = dict(causal=causal, scale=scale or D ** -0.5, alibi=al)
            ref, ref_lse = k3.flash_fwd_plain(q, k, v, qo, kl, window=None, softcap=None, **cfg)
            rows = torch.isfinite(ref_lse).transpose(1, 2)
            worst = {}
            for tag in ("old", "new"):
                use(tag)
                out, _ = k3.flash_fwd_f32(q, k, v, qo, kl, **cfg)
                worst[tag] = float(cs.f32_row_err(out, ref, v, Hq)[rows].max() / cs.F32_ROW_TOL)
            us = turns(["old", "new"], lambda: k3.flash_fwd_f32(q, k, v, qo, kl, **cfg))
            print(json.dumps({"kernel": "flash_attention_f32", "case": name,
                              "worst_row_over_tol": worst, "us": us}), flush=True)
            del q, k, v, ref, ref_lse
        for name, B, S, Hq, Hk, D, alibi, scale, rate, short in cs.ZOO_K6_CASES:
            q, do = (torch.randn((B, S, Hq, D), generator=g, device=dev) for _ in range(2))
            k, v = (torch.randn((B, S, Hk, D), generator=g, device=dev) for _ in range(2))
            qo = torch.zeros((B,), dtype=torch.int32, device=dev)
            kl = torch.full((B,), S, dtype=torch.int32, device=dev)
            kl[-1] -= short
            al = default_alibi_slopes(Hq, dev)[None].expand(B, Hq).contiguous() if alibi else None
            cfg = dict(causal=True, scale=scale or D ** -0.5, alibi=al, dropout_p=rate,
                       dropout_seed=cs.DROPOUT_SEED)
            use("new")
            out, lse = k3.flash_fwd_f32(q, k, v, qo, kl, **cfg)
            args = (q, k, v, out, lse, do)
            ref = k6.flash_attention_bwd_plain(*args, q_offset=qo, kv_lens=kl, window=None,
                                               softcap=None, **cfg)
            n = plan(B, S, Hk, Hq // Hk, D)
            tags = ["old", "new"] + (["new, one slice"] if n > 1 else [])
            worst = {}
            for tag in tags:
                use(tag)
                got = k6.flash_attention_bwd_f32(*args, q_offset=qo, kv_lens=kl, **cfg)
                worst[tag] = {w: float(cs.f32_grad_err(a, b).max() / cs.F32_GRAD_TOL)
                              for w, a, b in zip(("dq", "dk", "dv"), got, ref)}
            us = turns(tags, lambda: k6.flash_attention_bwd_f32(*args, q_offset=qo, kv_lens=kl,
                                                                **cfg))
            _, di = k6.flash_bwd_f32_dq(q, k, v, out, do, lse, qo, kl, **cfg)
            dkv_us = turns(tags, lambda: k6.flash_bwd_f32_dkv(q, k, v, do, lse, di, qo, kl,
                                                              **cfg))
            print(json.dumps({"kernel": "flash_attention_bwd_f32", "case": name, "slices": n,
                              "worst_row_over_tol": worst, "us": us, "dkv_us": dkv_us}),
                  flush=True)
            del q, k, v, do, out, lse, ref
            torch.cuda.empty_cache()
    finally:
        use("new")


#: k6-f32-slices shapes: name, B, S, Hq, Hk, D.
_SLICE_SHAPES = (("santacoder B4 S1024 Hq16 Hk1 D128", 4, 1024, 16, 1, 128),
                 ("gqa-8 B4 S1024 Hq32 Hk4 D128", 4, 1024, 32, 4, 128),
                 ("falcon-7b train B8 S512 Hq71 Hk1 D64", 8, 512, 71, 1, 64))


def k6_f32_slices(dev: torch.device) -> None:
    from ..kernels import flash_attention as k3
    from ..kernels import flash_attention_bwd as k6

    g = torch.Generator(device=dev).manual_seed(1)
    plan = k6.dkv_slices
    try:
        for name, B, S, Hq, Hk, D in _SLICE_SHAPES:
            q, do = (torch.randn((B, S, Hq, D), generator=g, device=dev) for _ in range(2))
            k, v = (torch.randn((B, S, Hk, D), generator=g, device=dev) for _ in range(2))
            qo = torch.zeros((B,), dtype=torch.int32, device=dev)
            kl = torch.full((B,), S, dtype=torch.int32, device=dev)
            cfg = dict(causal=True, scale=D ** -0.5, alibi=None)
            out, lse = k3.flash_fwd_f32(q, k, v, qo, kl, **cfg)
            _, di = k6.flash_bwd_f32_dq(q, k, v, out, do, lse, qo, kl, **cfg)
            group = Hq // Hk
            us = {}
            for n in (n for n in range(1, group + 1) if group % n == 0):
                k6.dkv_slices = lambda *a, n=n: n
                us[n] = _graph_ms(lambda: k6.flash_bwd_f32_dkv(q, k, v, do, lse, di, qo, kl,
                                                               **cfg), calls=5) * 1e3
            k6.dkv_slices = plan
            print(json.dumps({"case": name, "plan": plan(B, S, Hk, group, D), "dkv_us": us}),
                  flush=True)
    finally:
        k6.dkv_slices = plan


def main(argv=None) -> None:
    parts = (argv if argv is not None else sys.argv[1:]) or ["k1-splits", "k1-merge", "k7-exp"]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants times kernels on a CUDA card")
    dev = torch.device("cuda")
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    if parts[0] in ("k3k6-bits", "k3k6-f32"):
        if len(parts) != 2:
            raise SystemExit(f"{parts[0]} takes one argument: an older checkout's csrc directory")
        (k3k6_bits if parts[0] == "k3k6-bits" else k3k6_f32)(dev, Path(parts[1]))
        return
    for part in parts:
        {"k1-splits": k1_splits, "k1-merge": k1_merge, "k7-exp": k7_exp,
         "k6-f32-slices": k6_f32_slices}[part](dev)


if __name__ == "__main__":
    main()
