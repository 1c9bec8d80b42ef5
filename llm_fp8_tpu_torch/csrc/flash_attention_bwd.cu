// K6: flash-attention backward, dK/dV and dQ, over bshd bf16 tensors.
//
// Replaces llm_fp8_tpu/kernels/flash_attention_bwd.py::flash_attention_bwd
// (_dkv_kernel, _dq_kernel, _recompute_p_and_ds). The softmax weights are
// recomputed per tile from the forward's saved log-sum-exp (K3's [B, Hq, Sq]),
// so no [Sq, Sk] matrix reaches device memory. Per tile, in float32:
//   z  = scale·QKᵀ (capped: softcap·tanh(z/softcap)),  masked as K3
//   p  = exp(z - lse) on live pairs of rows with a finite lse, else 0
//   ds = p·(dO·Vᵀ - di) (· (1 - (z/softcap)²)) · scale,  di = rowsum(o·dO)
//   dV += bf16(p)ᵀ·dO,  dK += bf16(ds)ᵀ·Q,  dQ += bf16(ds)·K
// with p and ds rounded to bf16 before their products, as the TPU kernel.
// Features: causal with a per-batch q_offset, kv_lens, GQA, sliding window,
// softcap and the logit scale (ALiBi, attention_chunk, segments and dropout
// are not ported and raise in the wrapper).
//
// Bound on the H100: operations. The backward's function is 2.5x the
// forward's matrix work (five products per live pair to the forward's two;
// these kernels do seven, S and dP in both); at the training shape (B 8,
// S 512, Hq 32, D 64, causal) that is ~21.5 GFLOP per layer, ~22 µs at
// 989 TFLOP/s bf16.
//
// Design: two kernels with no atomics, so two runs give the same bits.
//   dKV: one block of four warps per (64-key tile, kv head, batch row). It
//        walks the (group head, 64-query tile) pairs that can reach its keys
//        (causal, kv_len and window skip dead tiles) in the TPU kernel's
//        order, g-major, and sums the GQA group in its float32 dK/dV
//        accumulators. Each warp owns 16 keys: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ run
//        on WMMA bf16 16x16x16 with float32 accumulators into shared memory,
//        the warp turns its rows into bf16 Pᵀ and dSᵀ, and accumulates
//        Pᵀ·dO and dSᵀ·Q in register fragments.
//   dQ:  one block per (64-query tile, q head, batch row), walking the key
//        tiles K3's forward walks; each warp owns 16 queries.
// Every offset into q/k/v/o/do/dq/dk/dv is 64-bit.
#include <math.h>
#include <mma.h>

#include "fp8_ftz.cuh"

using namespace nvcuda;

namespace {

constexpr int kBQ = 64, kBK = 64, kWarps = 4, kThreads = kWarps * 32;

template <int D>
struct BwdSmem {
  static constexpr int LDT = D + 8;     // bf16 tiles [64][D]
  static constexpr int LDS = 64 + 4;    // float32 [64][64] score tiles
  static constexpr int LDP = 64 + 8;    // bf16 [64][64] P / dS tiles
  static constexpr int LDO = D + 4;     // float32 [64][D] result staging
  static constexpr int A = 0;                        // K (dKV) or Q (dQ)
  static constexpr int B = A + 64 * LDT * 2;         // V (dKV) or dO (dQ)
  static constexpr int C = B + 64 * LDT * 2;         // Q (dKV) or K (dQ)
  static constexpr int E = C + 64 * LDT * 2;         // dO (dKV) or V (dQ)
  static constexpr int S = E + 64 * LDT * 2;         // scores, then results
  static constexpr int DP = S + 64 * LDS * 4;        // dP
  static constexpr int P = DP + 64 * LDS * 4;        // bf16 P (dKV only)
  static constexpr int DS = P + 64 * LDP * 2;        // bf16 dS
  static constexpr int ROW = DS + 64 * LDP * 2;      // lse[64], di[64]
  static constexpr int BYTES = ROW + 2 * 64 * 4;
  static_assert(64 * LDO * 4 <= 2 * 64 * LDS * 4, "result staging overflows S+DP");
};

struct Mask {
  float scale, softcap;
  int causal, window, kv_len;

  __device__ __forceinline__ bool live(int q_pos, int k_pos) const {
    bool ok = k_pos < kv_len;
    if (causal) ok = ok && k_pos <= q_pos;
    if (window > 0) ok = ok && k_pos > q_pos - window;
    return ok;
  }

  // p and ds of one (query, key) pair from the raw dot q·k, dO·v, the row's
  // lse and di (the TPU kernel's _recompute_p_and_ds, element by element).
  __device__ __forceinline__ void p_ds(float qk, float dp, float lse, float di, bool ok,
                                       float& p, float& ds) const {
    const float s = qk * scale;
    const float z = softcap > 0.0f ? softcap * tanhf(s / softcap) : s;
    p = (ok && isfinite(lse)) ? expf(z - lse) : 0.0f;
    float d = p * (dp - di);
    if (softcap > 0.0f) {
      const float t = z / softcap;
      d = d * (1.0f - t * t);
    }
    ds = d * scale;
  }
};

// Copies `rows` rows of D bf16 (row r at src + r * stride) into smem with
// leading dimension ld, zero-filling rows >= valid.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          size_t stride, int rows, int valid) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < rows * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + cc);
    *reinterpret_cast<uint4*>(dst + r * ld + cc) = v;
  }
}

// dst[16 rows of this warp][64] = A[16][D] · Bᵀ, with B given row-major as
// [64][D] (so Bᵀ is read col-major): the score-shaped products Q·Kᵀ, K·Qᵀ,
// dO·Vᵀ and V·dOᵀ.
template <int D>
__device__ __forceinline__ void warp_abt(float* dst, int ldd, const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int ld) {
#pragma unroll
  for (int j = 0; j < 64 / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + d * 16, ld);
      wmma::load_matrix_sync(fb, b + (j * 16) * ld + d * 16, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst + j * 16, acc, ldd, wmma::mem_row_major);
  }
}

// acc[D/16] += A[16 rows][64] (bf16, row-major, ld lda) · B[64][D] (row-major).
template <int D>
__device__ __forceinline__ void warp_ab_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + (kk * 16) * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Writes this warp's 16 accumulator rows as bf16 to rows row0.. of out
// (row r at out + r * stride), staging them through `stage` (float32, ld LDO).
template <int D>
__device__ __forceinline__ void warp_store(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], float* stage,
    __nv_bfloat16* out, size_t stride, int row0, int rows_valid) {
  constexpr int LDO = BwdSmem<D>::LDO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* w = stage + (warp * 16) * LDO;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(w + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + warp * 16 + r;
    if (row >= rows_valid) break;
    __nv_bfloat16* o = out + static_cast<size_t>(row) * stride;
    for (int d = lane; d < D; d += 32) o[d] = __float2bfloat16_rn(w[r * LDO + d]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                     int Sk, int Hq, int Hk, float scale, int causal, int window,
                     float softcap) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::A);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::B);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::C);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::E);
  float* St = reinterpret_cast<float*>(smem + L::S);
  float* dPt = reinterpret_cast<float*>(smem + L::DP);
  __nv_bfloat16* Pt = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  __nv_bfloat16* dSt = reinterpret_cast<__nv_bfloat16*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW);
  float* di_s = lse_s + 64;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int groups = Hq / Hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = kt * kBK;
  const int q_off = q_offset[b];
  const Mask mask{scale, softcap, causal, window, min(kv_lens[b], Sk)};

  const size_t q_stride = static_cast<size_t>(Hq) * D, kv_stride = static_cast<size_t>(Hk) * D;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(hk) * D;
  load_rows<D>(Ks, L::LDT, k + kv_base + k0 * kv_stride, kv_stride, kBK, Sk - k0);
  load_rows<D>(Vs, L::LDT, v + kv_base + k0 * kv_stride, kv_stride, kBK, Sk - k0);

  // Query tiles that can hold a live (q, k) pair for some key of this tile.
  const int nq = (Sq + kBQ - 1) / kBQ;
  int qt_begin = 0, qt_end = k0 < mask.kv_len ? nq : 0;
  if (causal) {
    const int n = k0 - q_off;  // first query index whose position reaches k0
    qt_begin = n > 0 ? n / kBQ : 0;
  }
  if (window > 0) {
    const int n = k0 + window + kBK - 2 - q_off;  // last query index a key here reaches
    qt_end = min(qt_end, n >= 0 ? n / kBQ + 1 : 0);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }

  const __nv_bfloat16* Kw = Ks + (warp * 16) * L::LDT;
  const __nv_bfloat16* Vw = Vs + (warp * 16) * L::LDT;
  float* Sw = St + (warp * 16) * L::LDS;
  float* dPw = dPt + (warp * 16) * L::LDS;
  __nv_bfloat16* Pw = Pt + (warp * 16) * L::LDP;
  __nv_bfloat16* dSw = dSt + (warp * 16) * L::LDP;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
    const size_t row_base = (static_cast<size_t>(b) * Hq + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_rows<D>(Qs, L::LDT, q + q_base + q0 * q_stride, q_stride, kBQ, Sq - q0);
      load_rows<D>(dOs, L::LDT, dout + q_base + q0 * q_stride, q_stride, kBQ, Sq - q0);
      for (int i = tid; i < kBQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        lse_s[i] = in ? lse[row_base + q0 + i] : -INFINITY;
        di_s[i] = in ? di[row_base + q0 + i] : 0.0f;
      }
      __syncthreads();

      warp_abt<D>(Sw, L::LDS, Kw, Qs, L::LDT);    // Sᵀ rows of this warp's keys
      warp_abt<D>(dPw, L::LDS, Vw, dOs, L::LDT);  // dPᵀ
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int k_pos = k0 + warp * 16 + r;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = lane + 32 * i;
          float p, ds;
          mask.p_ds(Sw[r * L::LDS + c], dPw[r * L::LDS + c], lse_s[c], di_s[c],
                    mask.live(q_off + q0 + c, k_pos), p, ds);
          Pw[r * L::LDP + c] = __float2bfloat16_rn(p);
          dSw[r * L::LDP + c] = __float2bfloat16_rn(ds);
        }
      }
      __syncwarp();
      warp_ab_acc<D>(dv_acc, Pw, L::LDP, dOs, L::LDT);  // dV += Pᵀ·dO
      warp_ab_acc<D>(dk_acc, dSw, L::LDP, Qs, L::LDT);  // dK += dSᵀ·Q
    }
  }

  // The staging rows of a warp overlap other warps' score rows unless D is 64.
  __syncthreads();
  __nv_bfloat16* dk_b = dk + kv_base;
  __nv_bfloat16* dv_b = dv + kv_base;
  warp_store<D>(dk_acc, St, dk_b, kv_stride, k0, Sk);
  __syncwarp();
  warp_store<D>(dv_acc, St, dv_b, kv_stride, k0, Sk);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq, int Hk,
                    float scale, int causal, int window, float softcap) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::A);
  __nv_bfloat16* dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::B);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::C);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::E);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  __nv_bfloat16* dSs = reinterpret_cast<__nv_bfloat16*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::ROW);
  float* di_s = lse_s + 64;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * kBQ;
  const int q_off = q_offset[b];
  const Mask mask{scale, softcap, causal, window, min(kv_lens[b], Sk)};

  const size_t q_stride = static_cast<size_t>(Hq) * D, kv_stride = static_cast<size_t>(Hk) * D;
  const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
  const size_t row_base = (static_cast<size_t>(b) * Hq + h) * Sq;
  load_rows<D>(Qs, L::LDT, q + q_base + q0 * q_stride, q_stride, kBQ, Sq - q0);
  load_rows<D>(dOs, L::LDT, dout + q_base + q0 * q_stride, q_stride, kBQ, Sq - q0);
  for (int i = tid; i < kBQ; i += kThreads) {
    const bool in = q0 + i < Sq;
    lse_s[i] = in ? lse[row_base + q0 + i] : -INFINITY;
    di_s[i] = in ? di[row_base + q0 + i] : 0.0f;
  }

  // Key tiles that can hold a live (q, k) pair for some row (as K3's forward).
  const int q_min = q_off + q0, q_max = q_off + min(q0 + kBQ, Sq) - 1;
  int k_hi = mask.kv_len;
  if (causal) k_hi = min(k_hi, q_max + 1);
  const int kt_end = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;
  int kt_begin = 0;
  if (window > 0 && q_min - window + 1 > 0) kt_begin = (q_min - window + 1) / kBK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);

  const __nv_bfloat16* Qw = Qs + (warp * 16) * L::LDT;
  const __nv_bfloat16* dOw = dOs + (warp * 16) * L::LDT;
  float* Sw = Ss + (warp * 16) * L::LDS;
  float* dPw = dPs + (warp * 16) * L::LDS;
  __nv_bfloat16* dSw = dSs + (warp * 16) * L::LDP;
  const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(hk) * D;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(Ks, L::LDT, k + kv_base + k0 * kv_stride, kv_stride, kBK, Sk - k0);
    load_rows<D>(Vs, L::LDT, v + kv_base + k0 * kv_stride, kv_stride, kBK, Sk - k0);
    __syncthreads();

    warp_abt<D>(Sw, L::LDS, Qw, Ks, L::LDT);    // S rows of this warp's queries
    warp_abt<D>(dPw, L::LDS, dOw, Vs, L::LDT);  // dP
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int q_pos = q_off + q0 + row;
      const float l = lse_s[row], d_i = di_s[row];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        float p, ds;
        mask.p_ds(Sw[r * L::LDS + c], dPw[r * L::LDS + c], l, d_i,
                  mask.live(q_pos, k0 + c), p, ds);
        dSw[r * L::LDP + c] = __float2bfloat16_rn(ds);
      }
    }
    __syncwarp();
    warp_ab_acc<D>(dq_acc, dSw, L::LDP, Ks, L::LDT);  // dQ += dS·K
  }

  __syncthreads();  // the staging area overlaps tiles other warps may still read
  warp_store<D>(dq_acc, Ss, dq + q_base, q_stride, q0, Sq);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, const void* q_offset, const void* kv_lens, void* dk, void* dv,
               int B, int Sq, int Sk, int Hq, int Hk, float scale, int causal, int window,
               float softcap, cudaStream_t s) {
  constexpr int bytes = BwdSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sk + kBK - 1) / kBK, Hk, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Sk, Hq, Hk, scale,
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* di, const void* q_offset, const void* kv_lens, void* dq, int B,
              int Sq, int Sk, int Hq, int Hk, float scale, int causal, int window,
              float softcap, cudaStream_t s) {
  constexpr int bytes = BwdSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, Hq, Hk, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 and softcap <= 0 mean "off". D is 32, 64 or 128.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di,
                                    const void* q_offset, const void* kv_lens, void* dk,
                                    void* dv, int B, int Sq, int Sk, int Hq, int Hk, int D,
                                    float scale, int causal, int window, float softcap,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, B, Sq, Sk, Hq,
                            Hk, scale, causal, window, softcap, s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, B, Sq, Sk, Hq,
                            Hk, scale, causal, window, softcap, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, B, Sq, Sk, Hq,
                             Hk, scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* di,
                                   const void* q_offset, const void* kv_lens, void* dq, int B,
                                   int Sq, int Sk, int Hq, int Hk, int D, float scale,
                                   int causal, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, di, q_offset, kv_lens, dq, B, Sq, Sk, Hq, Hk,
                           scale, causal, window, softcap, s);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, di, q_offset, kv_lens, dq, B, Sq, Sk, Hq, Hk,
                           scale, causal, window, softcap, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, di, q_offset, kv_lens, dq, B, Sq, Sk, Hq, Hk,
                            scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
