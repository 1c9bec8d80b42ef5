// K8: fused residual add + RMSNorm over the last axis, one pass per row.
//
// Replaces llm_fp8_tpu/kernels/rmsnorm.py::rmsnorm_residual_fused (_kernel).
// For each row of x and residual (float32 or bf16, [rows, D]) and a float32
// weight [D]:
//   s32 = x + r                      (float32)
//   var = sum(s32^2) / D             (float32, correctly rounded division)
//   y   = (s32 * rsqrt(var + eps)) * w
// and stores s and y in x's dtype; y comes from the unrounded float32 sum, as
// on the TPU. The rsqrt is the correctly rounded __frsqrt_rn: rsqrtf is up to
// 2 ulp off and would flip bf16 roundings of y against the plain version.
//
// Bound on the H100: bytes. x and r are read once, y and s written once:
// 4 * rows * D * itemsize, 67 MB at the forward probe's [4096, 2048] bf16,
// ~20 µs at 3.35 TB/s.
//
// Design: one warp per row, eight rows per block of 256 threads; 16-byte
// loads and stores (VEC elements a lane) where D and the pointers allow, else
// one element. The first pass writes s and sums s^2 (warp shuffles); the
// second writes y. Where D is 32 * VEC times 1, 2, 4, 8 or 16 (2048 in bf16
// and float32 at 1B), the loops are unrolled and the float32 sums wait in
// registers; otherwise the second pass reads the row's x and r again (from
// L1/L2). Rows past the last are masked, so any row count works.
#include "fp8_ftz.cuh"

namespace {

constexpr int kWarps = 8, kThreads = kWarps * 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// VEC values of T as one aligned vector (16 bytes when VEC * sizeof(T) = 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC weights from w + i as floats (16-byte loads when VEC is a multiple of 4).
template <int VEC>
__device__ __forceinline__ void load_w(float (&wv)[VEC], const float* w) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(w + e);
      wv[e] = f.x, wv[e + 1] = f.y, wv[e + 2] = f.z, wv[e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) wv[e] = w[e];
  }
}

// ITERS > 0: D == ITERS * 32 * VEC, and the row's float32 sums stay in
// registers between the passes (all loads of a lane issued at once). ITERS
// == 0: any D; the second pass reads x and r again.
template <typename T, int VEC, int ITERS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_residual_kernel(const T* __restrict__ x, const T* __restrict__ r,
                        const float* __restrict__ w, T* __restrict__ y,
                        T* __restrict__ s, int rows, int D, float eps) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * D;

  // One chunk of VEC values at column i: s32 = x + r into v, s stored.
  auto sum_chunk = [&](int i, float (&v)[VEC], float& sumsq) {
    const P a = *reinterpret_cast<const P*>(x + base + i);
    const P b = *reinterpret_cast<const P*>(r + base + i);
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[e] = to_float(a.v[e]) + to_float(b.v[e]);
      sumsq = fmaf(v[e], v[e], sumsq);
      from_float(v[e], &out.v[e]);
    }
    *reinterpret_cast<P*>(s + base + i) = out;
  };
  auto norm_chunk = [&](int i, const float (&v)[VEC], float rstd) {
    float wv[VEC];
    load_w<VEC>(wv, w + i);
    P out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) from_float(__fmul_rn(__fmul_rn(v[e], rstd), wv[e]), &out.v[e]);
    *reinterpret_cast<P*>(y + base + i) = out;
  };
  auto rstd_of = [&](float sumsq) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
    return __frsqrt_rn(__fadd_rn(__fdiv_rn(sumsq, static_cast<float>(D)), eps));
  };

  float sumsq = 0.0f;
  if constexpr (ITERS > 0) {
    float v[ITERS][VEC];
#pragma unroll
    for (int it = 0; it < ITERS; ++it) sum_chunk((it * 32 + lane) * VEC, v[it], sumsq);
    const float rstd = rstd_of(sumsq);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) norm_chunk((it * 32 + lane) * VEC, v[it], rstd);
  } else {
    float v[VEC];
    for (int i = lane * VEC; i < D; i += 32 * VEC) sum_chunk(i, v, sumsq);
    const float rstd = rstd_of(sumsq);
    for (int i = lane * VEC; i < D; i += 32 * VEC) {
      const P a = *reinterpret_cast<const P*>(x + base + i);
      const P b = *reinterpret_cast<const P*>(r + base + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = to_float(a.v[e]) + to_float(b.v[e]);
      norm_chunk(i, v, rstd);
    }
  }
}

template <typename T, int VEC, int ITERS>
void start(const void* x, const void* r, const void* w, void* y, void* s, int rows, int D,
           float eps, cudaStream_t stream) {
  rmsnorm_residual_kernel<T, VEC, ITERS><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const float*>(w),
      static_cast<T*>(y), static_cast<T*>(s), rows, D, eps);
}

template <typename T>
int launch(const void* x, const void* r, const void* w, void* y, void* s, int rows, int D,
           float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(w)) %
                        16) == 0;
  if (!aligned || D % kVec != 0) {
    start<T, 1, 0>(x, r, w, y, s, rows, D, eps, stream);
  } else {
    switch (D / (32 * kVec) * (D % (32 * kVec) == 0)) {
      case 1: start<T, kVec, 1>(x, r, w, y, s, rows, D, eps, stream); break;
      case 2: start<T, kVec, 2>(x, r, w, y, s, rows, D, eps, stream); break;
      case 4: start<T, kVec, 4>(x, r, w, y, s, rows, D, eps, stream); break;
      case 8: start<T, kVec, 8>(x, r, w, y, s, rows, D, eps, stream); break;
      case 16: start<T, kVec, 16>(x, r, w, y, s, rows, D, eps, stream); break;
      default: start<T, kVec, 0>(x, r, w, y, s, rows, D, eps, stream); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind 0: float32 x, r, y, s; kind 1: bf16; all [rows, D] contiguous. The
// weight is float32 [D]. Unaligned rows take the one-element loads.
extern "C" int rmsnorm_residual_launch(const void* x, const void* r, const void* w, void* y,
                                       void* s, int rows, int D, int kind, float eps,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (kind == 0) return launch<float>(x, r, w, y, s, rows, D, eps, st);
  if (kind == 1) return launch<__nv_bfloat16>(x, r, w, y, s, rows, D, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
