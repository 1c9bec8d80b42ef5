// K1: y[M,N] = x[M,K] (bf16) @ dequant(w[K,N]) with a float32 accumulator.
//
// Replaces llm_fp8_tpu/kernels/quant_matmul.py::quant_matmul (Pallas kernels
// _kernel_tensor_or_channel and _kernel_mx). Modes: "tensor" and "channel"
// scale the accumulator after the dot (the scale is constant along K); "mx"
// multiplies each 32-row weight block by its power-of-two scale before it
// (scales vary along K). Weights are e4m3, e5m2 or int8 codes.
//
// Bound on the H100: at decode (M = slots = 8) every weight byte is read once
// for 16 FLOPs, far below the 295 FLOP/byte ridge, so the kernel is bound by
// the K*N weight bytes (gate|up at 1B: 33.6 MB → 10 µs at 3.35 TB/s). At
// prefill (M = 128..2048) it moves toward the bf16 tensor-core bound.
//
// Design: weights stream from device memory as 1-byte codes, 16 bytes per
// thread per load, and are dequantized in registers (e4m3 by the FTZ route
// of fp8_ftz.cuh, e5m2 and int8 exactly, as the TPU kernel does) straight
// into a bf16 shared-memory tile; the weight never exists in bf16 in device
// memory. WMMA bf16 16x16x16 products accumulate in float32. The next tile's
// loads are issued before the current tile's products (register double
// buffering) so bytes stay in flight. Small M uses 16-row tiles; when the
// (M, N) grid cannot fill the card, K is split across blocks that write
// float32 partials, and a second kernel sums them in a fixed order, applies
// the scale and casts (deterministic, no atomics). Ragged M, N and K edges
// are masked in the kernel; nothing is padded in device memory.
#include <mma.h>

#include "fp8_ftz.cuh"

using namespace nvcuda;

namespace {

constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 64;   // contraction depth per tile
constexpr int kThreads = 128;
constexpr int kModeTensor = 0, kModeChannel = 1, kModeMX = 2;

// Weight code → float as the TPU kernel's _dequant_to: e4m3 by the FTZ
// route, e5m2 and int8 by an exact convert.
template <int KIND>
__device__ __forceinline__ float weight_to_float(uint32_t b) {
  if constexpr (KIND == kCodeE5M2) return e5m2_exact_to_float(b);
  else return code_to_float<KIND>(b);
}

template <int BM, int WM, int WN, int KIND>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, void* __restrict__ out,
           float* __restrict__ partial, int M, int N, int K, int mode,
           int out_f32, int k_tiles_per_split) {
  constexpr int WTM = BM / WM, WTN = kBN / WN;  // warp tile
  constexpr int FM = WTM / 16, FN = WTN / 16;
  constexpr int LDA = kBK + 8, LDB = kBN + 8, LDC = kBN + 4;
  constexpr int A_BYTES = BM * LDA * 2, B_BYTES = kBK * LDB * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
  constexpr int W_CHUNKS = kBK * kBN / 16 / kThreads;  // 16-byte weight chunks
  constexpr int X_CHUNKS = BM * kBK / 8 / kThreads;    // 8-element x chunks
  static_assert(W_CHUNKS * 16 * kThreads == kBK * kBN, "weight tile split");
  static_assert(X_CHUNKS * 8 * kThreads == BM * kBK, "x tile split");
  static_assert(WM * WN == kThreads / 32, "one warp per warp tile");

  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt_begin = blockIdx.z * k_tiles_per_split;
  const int kt_end = min(kt_begin + k_tiles_per_split, k_tiles);
  const bool w_vec = (N % 16 == 0) && ((reinterpret_cast<uintptr_t>(w) & 15) == 0);
  const bool x_vec = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);

  uint4 wreg[W_CHUNKS];
  uint4 xreg[X_CHUNKS];

  auto load_tile = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBN / 16), n = n0 + (c % (kBN / 16)) * 16, k = k0 + r;
      if (w_vec && k < K && n + 16 <= N) {
        wreg[i] = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * N + n);
      } else {
        __align__(16) uint8_t b[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          b[j] = (k < K && n + j < N) ? w[static_cast<size_t>(k) * N + n + j] : 0;
        wreg[i] = *reinterpret_cast<const uint4*>(b);
      }
    }
#pragma unroll
    for (int i = 0; i < X_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), k = k0 + (c % (kBK / 8)) * 8, m = m0 + r;
      if (x_vec && m < M && k + 8 <= K) {
        xreg[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = (m < M && k + j < K) ? x[static_cast<size_t>(m) * K + k + j]
                                      : __float2bfloat16_rn(0.0f);
        xreg[i] = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  auto store_tile = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < W_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&wreg[i]);
      __align__(16) __nv_bfloat16 v[16];
      if (mode == kModeMX) {
        // Power-of-two scale: the bf16 product is exact, as on the TPU.
        const int k = min(k0 + r, K - 1), n = n0 + col;
        const float* srow = scale + static_cast<size_t>(k / 32) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float s = (n + j < N) ? srow[n + j] : 0.0f;
          v[j] = __float2bfloat16_rn(weight_to_float<KIND>(b[j]) * s);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = __float2bfloat16_rn(weight_to_float<KIND>(b[j]));
      }
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDB + col);
      dst[0] = reinterpret_cast<const uint4*>(v)[0];
      dst[1] = reinterpret_cast<const uint4*>(v)[1];
    }
#pragma unroll
    for (int i = 0; i < X_CHUNKS; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(As + r * LDA + col) = xreg[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (kt_begin < kt_end) load_tile(kt_begin);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    __syncthreads();  // the previous tile's products are done with smem
    store_tile(kt);
    __syncthreads();
    if (kt + 1 < kt_end) load_tile(kt + 1);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WTM + i * 16) * LDA + ks * 16, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, Bs + (ks * 16) * LDB + wn * WTN + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], bf, acc[i][j]);
      }
    }
  }

  __syncthreads();  // Cs aliases As/Bs
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const bool split = gridDim.z > 1;
  for (int idx = tid; idx < BM * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = Cs[r * LDC + c];
    const size_t o = static_cast<size_t>(m) * N + n;
    if (split) {
      partial[static_cast<size_t>(blockIdx.z) * M * N + o] = v;
      continue;
    }
    if (mode == kModeTensor) v *= scale[0];
    else if (mode == kModeChannel) v *= scale[n];
    if (out_f32) static_cast<float*>(out)[o] = v;
    else static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
  }
}

// Sums the split-K partials in split order, applies the scale and casts.
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale,
                                  void* __restrict__ out, int M, int N,
                                  int splits, int mode, int out_f32) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  float v = 0.0f;
  for (int z = 0; z < splits; ++z) v += partial[z * total + o];
  const int n = static_cast<int>(o % N);
  if (mode == kModeTensor) v *= scale[0];
  else if (mode == kModeChannel) v *= scale[n];
  if (out_f32) static_cast<float*>(out)[o] = v;
  else static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
}

template <int BM, int WM, int WN>
void launch_tiles(int kind, dim3 grid, cudaStream_t s, const __nv_bfloat16* x,
                  const uint8_t* w, const float* scale, void* out, float* partial,
                  int M, int N, int K, int mode, int out_f32, int ktps) {
  switch (kind) {
    case kCodeE4M3:
      qmm_kernel<BM, WM, WN, kCodeE4M3><<<grid, kThreads, 0, s>>>(
          x, w, scale, out, partial, M, N, K, mode, out_f32, ktps);
      break;
    case kCodeE5M2:
      qmm_kernel<BM, WM, WN, kCodeE5M2><<<grid, kThreads, 0, s>>>(
          x, w, scale, out, partial, M, N, K, mode, out_f32, ktps);
      break;
    default:
      qmm_kernel<BM, WM, WN, kCodeInt8><<<grid, kThreads, 0, s>>>(
          x, w, scale, out, partial, M, N, K, mode, out_f32, ktps);
      break;
  }
}

}  // namespace

// small != 0 selects 16-row tiles (decode), else 64-row tiles. With
// splits > 1, `partial` is a [splits, M, N] float32 workspace.
extern "C" int qmm_launch(const void* x, const void* w, const void* scale,
                          void* out, void* partial, int M, int N, int K,
                          int w_kind, int mode, int out_f32, int small,
                          int splits, int k_tiles_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* pp = static_cast<float*>(partial);
  if (small) {
    dim3 grid((N + kBN - 1) / kBN, (M + 15) / 16, splits);
    launch_tiles<16, 1, 4>(w_kind, grid, s, xp, wp, sp, out, pp, M, N, K, mode,
                           out_f32, k_tiles_per_split);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64, splits);
    launch_tiles<64, 2, 2>(w_kind, grid, s, xp, wp, sp, out, pp, M, N, K, mode,
                           out_f32, k_tiles_per_split);
  }
  if (splits > 1) {
    const size_t total = static_cast<size_t>(M) * N;
    qmm_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        pp, sp, out, M, N, splits, mode, out_f32);
  }
  return static_cast<int>(cudaGetLastError());
}
