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
// prefill (M ≥ 128) it is bound by the bf16 tensor cores (989 TFLOP/s).
//
// Two kernels; the wrapper picks by M (kernels/quant_matmul.py).
//
// The decode kernel (small M, and shapes TMA cannot take): weights stream
// from device memory as 1-byte codes, 16 bytes per thread per load, and are
// dequantized in registers (e4m3 by the FTZ route of fp8_ftz.cuh, e5m2 and
// int8 exactly, as the TPU kernel does) straight into a bf16 shared-memory
// tile; the weight never exists in bf16 in device memory. WMMA bf16 16x16x16
// products accumulate in float32. The next tile's loads are issued before the
// current tile's products (register double buffering) so bytes stay in
// flight. Small M uses 16-row tiles.
//
// The prefill kernel (M ≥ 64; K a multiple of 8, N of 16): the decode
// kernel's 128 threads dequantized and multiplied in lockstep, with WMMA from
// shared memory and no load in flight while they converted. Here one
// producer thread keeps TMA loads of x tiles (bf16, 128-byte swizzle) and
// weight-code tiles (1 byte, [64 k][128 n], N contiguous) in a 4-stage
// mbarrier ring. Two consumer warpgroups dequantize each code tile once into
// a 3-deep ring of bf16 tiles in the swizzled MN-major layout wgmma reads
// (e4m3: the 7 payload bits re-seated in a float and one mul.ftz by 2^120,
// which flushes the subnormal codes; MX: times the scale in float, rounded
// once, as the plain version), 32 codes a thread, while the tensor cores
// run the products of the tile before: wgmma SS m64n128k16 (x K-major, the
// bf16 weight tile MN-major) with float32 accumulators in registers, each
// warpgroup owning 64 or 128 rows (128- or 256-row blocks) of a 128-column
// tile; one named barrier a k tile joins the two warpgroups. The design is
// SS and not the swapped-operand RS form: with the codes N-contiguous, an RS
// A fragment would gather single bytes across rows, while the converter reads
// 8 codes and writes 16 bytes at a time, 8 lanes to a swizzled row (no bank
// conflicts). Blocks are persistent (one per SM, walking the output tiles),
// so a tile's first loads overlap the epilogue of the tile before. The
// epilogue applies the tensor or channel scale and casts; a bf16 output is
// stored as 16-byte column groups after a transpose within each quad of
// lanes. Tried on the H100 and dropped, each slower at M = 8192: a separate
// converter warpgroup (its four warps could not keep the tensor cores fed),
// clusters of two blocks sharing x tiles by TMA multicast, integer
// e4m3 → bf16 bit moves in place of the float multiply, and a dequantize two
// k tiles ahead with a 4-deep weight ring (the TMA stages then come free a
// tile later than their loads need). The dequantize on
// the consumers' critical path and each tile's epilogue are what keep it
// behind torch.matmul's bf16 GEMM (PERF.md).
//
// Both kernels: when the (M, N) grid cannot fill the card, K is split
// across blocks that write float32 partials, and a second kernel sums them
// in a fixed order, applies the scale and casts (deterministic, no atomics).
// Ragged M, N and K edges are masked (or read as zeros by TMA); nothing is
// padded in device memory.
#include <mma.h>

#include "fp8_ftz.cuh"
#include "hopper.cuh"

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

// ---- the prefill kernel ----

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

constexpr int kPBN = 128;          // output columns per block
constexpr int kPBK = 64;           // contraction depth per stage
constexpr int kPStages = 4;        // TMA ring depth
constexpr int kPBufs = 3;          // bf16 weight-tile ring depth
constexpr int kPThreads = 288;     // two consumer warpgroups + one producer warp
constexpr int kPCodeBytes = kPBK * kPBN;      // one code tile
constexpr int kPTileBytes = kPBK * kPBN * 2;  // one bf16 weight tile (two 64-column chunks)

// Shared-memory layout of a block whose warpgroups own R slabs of 64 rows.
template <int R>
struct PSmem {
  static constexpr int BM = 2 * 64 * R;
  static constexpr int XB = BM * kPBK * 2;  // one x tile
  static constexpr int X = 0;
  static constexpr int C = X + kPStages * XB;
  static constexpr int W = C + kPStages * kPCodeBytes;
  static constexpr int BAR = W + kPBufs * kPTileBytes;
  static constexpr int BYTES = BAR + 2 * kPStages * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// One e4m3 code (the top byte of `top`) → float by the FTZ route: its 7
// payload bits re-seated in the float pattern and one multiply by 2^120 with
// subnormal inputs flushed (mul.ftz), which turns the codes whose exponent
// field is 0 into ±0.
__device__ __forceinline__ float e4m3_top_to_float_ftz(uint32_t top) {
  const uint32_t bits = (top & 0x80000000u) | ((top >> 4) & 0x07F00000u);
  float v;
  asm("mul.ftz.f32 %0, %1, 0f7B800000;\n" : "=f"(v) : "f"(__uint_as_float(bits)));
  return v;
}

// 8 codes (one uint2) → 8 bf16 (one uint4), times the MX scales of the 8
// columns at `s` (16-byte aligned, in device memory) if MX.
template <int KIND, bool MX>
__device__ __forceinline__ uint4 convert8(const uint2 codes, const float* s) {
  const uint32_t w[2] = {codes.x, codes.y};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float f[4];
    if constexpr (KIND == kCodeE4M3) {
      f[0] = e4m3_top_to_float_ftz(w[i] << 24);
      f[1] = e4m3_top_to_float_ftz(w[i] << 16);
      f[2] = e4m3_top_to_float_ftz(w[i] << 8);
      f[3] = e4m3_top_to_float_ftz(w[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] = weight_to_float<KIND>((w[i] >> (8 * j)) & 0xFFu);
    }
    if constexpr (MX) {
      const float4 sc = __ldg(reinterpret_cast<const float4*>(s) + i);
      f[0] *= sc.x;
      f[1] *= sc.y;
      f[2] *= sc.z;
      f[3] *= sc.w;
    }
    o[2 * i] = hopper::pack_bf16(f[0], f[1]);
    o[2 * i + 1] = hopper::pack_bf16(f[2], f[3]);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// The tensor or channel scale of columns n, n + 1 (MX scales come before
// the dot).
template <bool MX>
__device__ __forceinline__ void scale_pair(float2& v, const float* __restrict__ scale, int mode,
                                           int n) {
  if constexpr (!MX) {
    if (mode == kModeTensor) {
      v.x *= scale[0];
      v.y *= scale[0];
    } else {
      const float2 s = __ldg(reinterpret_cast<const float2*>(scale + n));
      v.x *= s.x;
      v.y *= s.y;
    }
  }
}

// Lane q of a quad holds row q of a 4x4 matrix in p; afterwards it holds
// column q (p[k] = the old p[q] of lane k).
__device__ __forceinline__ void quad_transpose(uint32_t (&p)[4], int q) {
  const int lane = threadIdx.x % 32;
  const bool b0 = q & 1, b1 = q & 2;
#pragma unroll
  for (int j = 0; j < 4; j += 2) {  // swap the off-diagonal elements of 2x2 blocks
    const uint32_t y = __shfl_sync(0xffffffffu, b0 ? p[j] : p[j + 1], lane ^ 1);
    if (b0) p[j] = y;
    else p[j + 1] = y;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // swap the off-diagonal 2x2 blocks
    const uint32_t y = __shfl_sync(0xffffffffu, b1 ? p[j] : p[j + 2], lane ^ 2);
    if (b1) p[j] = y;
    else p[j + 2] = y;
  }
}

// A persistent block: it walks the output tiles blockIdx.x, + gridDim.x, ...
// (tile = (N tile, M tile, K split), N fastest), so the loads of a tile's
// first k tiles overlap the epilogue of the tile before.
template <int R, int KIND, bool MX>
__global__ void __launch_bounds__(kPThreads, 1)
qmm_prefill_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ scale, void* __restrict__ out,
                   float* __restrict__ partial, int M, int N, int K, int mode, int out_f32,
                   int splits, int k_tiles_per_split) {
  using namespace hopper;
  using L = PSmem<R>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  auto full = [&](int s) { return base + L::BAR + 8u * s; };
  auto empty = [&](int s) { return base + L::BAR + 8u * (kPStages + s); };

  const int n_tiles = (N + kPBN - 1) / kPBN, m_tiles = (M + L::BM - 1) / L::BM;
  const int tiles = n_tiles * m_tiles * splits;
  const int k_tiles = (K + kPBK - 1) / kPBK;
  // The tile's origin and its k tiles [kt0, kt0 + nt).
  auto tile_at = [&](int tile, int& n0, int& m0, int& z, int& kt0, int& nt) {
    n0 = (tile % n_tiles) * kPBN;
    m0 = ((tile / n_tiles) % m_tiles) * L::BM;
    z = tile / (n_tiles * m_tiles);
    kt0 = z * k_tiles_per_split;
    nt = min(kt0 + k_tiles_per_split, k_tiles) - kt0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every load ----
    if (threadIdx.x == 256) {
      int g = 0;  // k tiles loaded so far (all tiles)
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int n0, m0, z, kt0, nt;
        tile_at(tile, n0, m0, z, kt0, nt);
        for (int j = 0; j < nt; ++j, ++g) {
          const int s = g % kPStages, k0 = (kt0 + j) * kPBK;
          if (g >= kPStages) mbar_wait(empty(s), ((g / kPStages) - 1) & 1);
          mbar_arrive_expect_tx(full(s), L::XB + kPCodeBytes);
          tma_load_2d(base + L::X + s * L::XB, &tx, full(s), k0, m0);
          tma_load_2d(base + L::C + s * kPCodeBytes, &tw, full(s), n0, k0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64·R·wg .. + 64·R - 1 of a tile ----
  const int t = threadIdx.x, wg = t / 128, warp = (t % 128) / 32, lane = t % 32;
  // This thread's share of the dequantize: rows r0 .. r0 + 3 (one 32-row MX
  // block) of each code tile, 8 columns from c8·8, so that the 16-byte
  // writes of 8 neighbouring lanes fill one swizzled 128-byte row (no bank
  // conflicts).
  const int c8 = t % 16, r0 = (t / 16) * 4;
  float acc[R][64];
  int g = 0;  // k tiles consumed so far (all tiles)
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int n0, m0, z, kt0, nt;
    tile_at(tile, n0, m0, z, kt0, nt);

    // Dequantizes k tile j of this tile (stage and weight buffer of g + j).
    auto convert = [&](int j) {
      const int s = (g + j) % kPStages;
      mbar_wait(full(s), ((g + j) / kPStages) & 1);
      const float* sc = scale;
      if constexpr (MX) {
        const int kb = min((kt0 + j) * kPBK + r0, K - 1) / 32;
        sc = scale + static_cast<size_t>(kb) * N + min(n0 + c8 * 8, N - 8);
      }
      const unsigned char* codes = gbase + L::C + s * kPCodeBytes;
      unsigned char* tile_w =
          gbase + L::W + ((g + j) % kPBufs) * kPTileBytes + (c8 / 8) * (kPBK * 128);
      const int u = c8 % 8;  // 16-byte unit of the 128-byte row, before the swizzle
#pragma unroll
      for (int r = r0; r < r0 + 4; ++r) {
        const uint2 c = *reinterpret_cast<const uint2*>(codes + r * kPBN + c8 * 8);
        *reinterpret_cast<uint4*>(tile_w + r * 128 + ((u ^ (r & 7)) * 16)) =
            convert8<KIND, MX>(c, sc);
      }
      fence_proxy_async();  // the tile is read by wgmma (the async proxy)
    };

    auto issue = [&](int j) {
      const uint32_t xs = base + L::X + ((g + j) % kPStages) * L::XB;
      const uint32_t ws = base + L::W + ((g + j) % kPBufs) * kPTileBytes;
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kPBK / 16; ++kk) {
        // B: rows 16kk.. of the MN-major tile; 64-column chunks 8192 bytes apart.
        const uint64_t db = make_desc(ws + kk * 16 * 128, kPBK * 128, 8 * 128, 128);
#pragma unroll
        for (int r = 0; r < R; ++r)
          wgmma_ss_n128_bt(acc[r], Tile<64>::kmajor(xs, L::BM, 64 * (R * wg + r), kk), db,
                           j > 0 || kk > 0);
      }
      wgmma_commit();
    };

    convert(0);
    consumers_sync();
    for (int j = 0; j < nt; ++j) {
      issue(j);
      if (j + 1 < nt) convert(j + 1);  // its buffer was last read by the products of j - 2
      wgmma_wait<1>();                 // the products of j - 1 are done
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
      if (j >= 1 && t % 128 == 0) mbar_arrive(empty((g + j - 1) % kPStages));
      consumers_sync();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < R; ++r) fence_regs(acc[r]);
    if (t % 128 == 0) mbar_arrive(empty((g + nt - 1) % kPStages));
    g += nt;

    // Epilogue: element i of a slab's accumulator is row 16·warp + lane/4 +
    // 8·((i >> 1) & 1), column 8·(i / 4) + 2·(lane % 4) + (i & 1).
    if (splits > 1 || out_f32) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int m = m0 + 64 * (R * wg + r) + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
          const int n = n0 + 8 * (i / 4) + 2 * (lane % 4);
          if (m >= M || n >= N) continue;  // N is a multiple of 16: n + 1 < N too
          const size_t o = static_cast<size_t>(m) * N + n;
          float2 v = make_float2(acc[r][i], acc[r][i + 1]);
          if (splits > 1) {
            *reinterpret_cast<float2*>(partial + static_cast<size_t>(z) * M * N + o) = v;
            continue;
          }
          scale_pair<MX>(v, scale, mode, n);
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = v;
        }
      }
    } else {
      // bf16 out: the four lanes of a quad hold two columns each of every
      // 8-column group; a 4x4 transpose over the quad (two butterfly
      // exchanges) gives each lane one whole group, stored as 16 bytes.
      const int q = lane % 4;
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 64 * (R * wg + r) + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
          for (int gq = 0; gq < 4; ++gq) {
            uint32_t pk[4];  // pk[k]: this lane's pair of group 4·gq + k
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int i = 4 * (4 * gq + k) + 2 * h;
              float2 v = make_float2(acc[r][i], acc[r][i + 1]);
              scale_pair<MX>(v, scale, mode, min(n0 + 8 * (4 * gq + k) + 2 * q, N - 2));
              pk[k] = pack_bf16(v.x, v.y);
            }
            quad_transpose(pk, q);
            const int n = n0 + 8 * (4 * gq + q);
            if (m < M && n < N)
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) +
                                        static_cast<size_t>(m) * N + n) =
                  make_uint4(pk[0], pk[1], pk[2], pk[3]);
          }
        }
      }
    }
  }
}

template <int R, int KIND, bool MX>
int launch_prefill(const void* x, const void* w, const float* scale, void* out, float* partial,
                   int M, int N, int K, int mode, int out_f32, int splits, int ktps,
                   cudaStream_t s) {
  using L = PSmem<R>;
  CUtensorMap tx, tw;
  int e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2LL * K, L::BM, kPBK, 128);
  if (e == 0)
    e = encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, N, kPBK, kPBN, 0);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(qmm_prefill_kernel<R, KIND, MX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((N + kPBN - 1) / kPBN) * ((M + L::BM - 1) / L::BM) * splits;
  qmm_prefill_kernel<R, KIND, MX><<<min(tiles, num_sms()), kPThreads, L::BYTES, s>>>(
      tx, tw, scale, out, partial, M, N, K, mode, out_f32, splits, ktps);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_prefill_kind(int kind, int mode, const void* x, const void* w, const float* scale,
                        void* out, float* partial, int M, int N, int K, int out_f32,
                        int splits, int ktps, cudaStream_t s) {
#define K1_PREFILL(KIND)                                                                   \
  return mode == kModeMX                                                                   \
             ? launch_prefill<R, KIND, true>(x, w, scale, out, partial, M, N, K, mode,     \
                                             out_f32, splits, ktps, s)                     \
             : launch_prefill<R, KIND, false>(x, w, scale, out, partial, M, N, K, mode,    \
                                              out_f32, splits, ktps, s)
  switch (kind) {
    case kCodeE4M3: K1_PREFILL(kCodeE4M3);
    case kCodeE5M2: K1_PREFILL(kCodeE5M2);
    case kCodeInt8: K1_PREFILL(kCodeInt8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K1_PREFILL
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

static void launch_reduce(const float* partial, const float* scale, void* out, int M, int N,
                   int splits, int mode, int out_f32, cudaStream_t s) {
  const size_t total = static_cast<size_t>(M) * N;
  qmm_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      partial, scale, out, M, N, splits, mode, out_f32);
}

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
  if (splits > 1) launch_reduce(pp, sp, out, M, N, splits, mode, out_f32, s);
  return static_cast<int>(cudaGetLastError());
}

// The prefill kernel: x [M, K] bf16 and w [K, N] codes row-major and 16-byte
// aligned, K a multiple of 8 and N of 16 (TMA's stride rules). rows = 128 or
// 256 (rows of x per block). With splits > 1, `partial` is a [splits, M, N]
// float32 workspace.
extern "C" int qmm_prefill_launch(const void* x, const void* w, const void* scale, void* out,
                                  void* partial, int M, int N, int K, int w_kind, int mode,
                                  int out_f32, int rows, int splits, int k_tiles_per_split,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const float*>(scale);
  auto* pp = static_cast<float*>(partial);
  if (K % 8 != 0 || N % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int e = rows == 256
                    ? launch_prefill_kind<2>(w_kind, mode, x, w, sp, out, pp, M, N, K, out_f32,
                                             splits, k_tiles_per_split, s)
                    : launch_prefill_kind<1>(w_kind, mode, x, w, sp, out, pp, M, N, K, out_f32,
                                             splits, k_tiles_per_split, s);
  if (e != 0) return e;
  if (splits > 1) launch_reduce(pp, sp, out, M, N, splits, mode, out_f32, s);
  return static_cast<int>(cudaGetLastError());
}
