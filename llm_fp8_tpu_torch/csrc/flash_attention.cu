// K3: flash-attention forward, out and log-sum-exp, over bshd bf16 tensors.
//
// Replaces llm_fp8_tpu/kernels/flash_attention.py::flash_attention (forward:
// _flash_fwd_call / _fwd_kernel). Features: causal with a per-batch q_offset,
// per-batch kv_lens, GQA through the head map (K/V are never repeated),
// sliding window, softcap and the logit scale. Dead rows (no live key) give
// out 0 and lse -inf, as on the TPU.
//
// Bound on the H100: a 128-token prefill bucket at Llama-3.2-1B (32 heads,
// head_dim 64, causal) is 67 MFLOP per layer, a few µs of launch and tile
// latency; long prompts approach the bf16 tensor-core bound (989 TFLOP/s).
//
// Design: one block of four warps per (64-query tile, q head, batch row).
// The block walks 64-key tiles from the first tile the window can reach to
// the last tile causality and kv_len allow (dead tiles are never loaded). Each
// warp owns 16 query rows: S = Q·Kᵀ and O += P·V run on WMMA bf16 16x16x16
// with float32 accumulators; the online softmax (running max m, sum l) runs
// on the warp's rows in shared memory with warp shuffles; P is rounded to
// bf16 before the PV product, as the TPU kernel does. Masked scores take the
// TPU kernel's finite MASK_VALUE so the dead-row test matches it.
#include <math.h>
#include <mma.h>

#include "fp8_ftz.cuh"

using namespace nvcuda;

namespace {

constexpr int kBQ = 64, kBKV = 64, kWarps = 4, kThreads = kWarps * 32;
constexpr float kMask = -0.7f * 3.4028234663852886e38f;

template <int D>
struct FlashSmem {
  static constexpr int LDQ = D + 8, LDS = kBKV + 4, LDP = kBKV + 8, LDO = D + 4;
  static constexpr int Q = 0;
  static constexpr int K = Q + kBQ * LDQ * 2;
  static constexpr int V = K + kBKV * LDQ * 2;
  static constexpr int S = V + kBKV * LDQ * 2;
  static constexpr int P = S + kBQ * LDS * 4;
  static constexpr int O = P + kBQ * LDP * 2;
  static constexpr int ML = O + kBQ * LDO * 4;
  static constexpr int BYTES = ML + 2 * kBQ * 4;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copies `rows` rows of D bf16 (row r at src + r * stride) into smem with
// leading dimension ld, zero-filling rows >= valid.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, size_t stride,
                                          int rows, int valid) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < rows * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + cc);
    *reinterpret_cast<uint4*>(dst + r * ld + cc) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ q_offset,
                 const int* __restrict__ kv_lens, int Sq, int Sk, int Hq, int Hk,
                 float scale, int causal, int window, float softcap) {
  using L = FlashSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* m_s = reinterpret_cast<float*>(smem + L::ML);
  float* l_s = m_s + kBQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hk);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * kBQ;
  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);

  const size_t q_stride = static_cast<size_t>(Hq) * D, kv_stride = static_cast<size_t>(Hk) * D;
  load_rows<D>(Qs, L::LDQ, q + (static_cast<size_t>(b) * Sq + q0) * q_stride + h * D,
               q_stride, kBQ, Sq - q0);
  for (int i = tid; i < kBQ * L::LDO; i += kThreads) Os[i] = 0.0f;
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }

  // Key tiles that can hold a live (q, k) pair for some row of this tile.
  const int q_min = q_off + q0, q_max = q_off + min(q0 + kBQ, Sq) - 1;
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_max + 1);
  const int kt_end = k_hi > 0 ? (k_hi + kBKV - 1) / kBKV : 0;
  int kt_begin = 0;
  if (window > 0 && q_min - window + 1 > 0) kt_begin = (q_min - window + 1) / kBKV;

  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d)
    wmma::load_matrix_sync(qf[d], Qs + (warp * 16) * L::LDQ + d * 16, L::LDQ);

  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Sk * kv_stride + kvh * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Sk * kv_stride + kvh * D;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(Ks, L::LDQ, kb + k0 * kv_stride, kv_stride, kBKV, Sk - k0);
    load_rows<D>(Vs, L::LDQ, vb + k0 * kv_stride, kv_stride, kBKV, Sk - k0);
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows.
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + (j * 16) * L::LDQ + d * 16, L::LDQ);
        wmma::mma_sync(sf, qf[d], kf, sf);
      }
      wmma::store_matrix_sync(Ss + (warp * 16) * L::LDS + j * 16, sf, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over the warp's rows; lanes cover the 64 keys.
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int q_pos = q_off + q0 + row;
      float s[kBKV / 32];
      float mx = kMask;
#pragma unroll
      for (int i = 0; i < kBKV / 32; ++i) {
        const int c = lane + 32 * i, k_pos = k0 + c;
        float x = Ss[row * L::LDS + c] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool live = k_pos < kv_len;
        if (causal) live = live && k_pos <= q_pos;
        if (window > 0) live = live && k_pos > q_pos - window;
        s[i] = live ? x : kMask;
        mx = fmaxf(mx, s[i]);
      }
      const float m_old = m_s[row], l_old = l_s[row];
      const float m_new = fmaxf(m_old, warp_max(mx));
      const float alpha = expf(m_old - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < kBKV / 32; ++i) {
        const float p = expf(s[i] - m_new);
        psum += p;
        Ps[row * L::LDP + lane + 32 * i] = __float2bfloat16_rn(p);
      }
      psum = warp_sum(psum);
      for (int d = lane; d < D; d += 32) Os[row * L::LDO + d] *= alpha;
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = alpha * l_old + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's rows.
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + (warp * 16) * L::LDO + j * 16, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + (warp * 16) * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(vf, Vs + (kk * 16) * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Os + (warp * 16) * L::LDO + j * 16, of, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int r = 0; r < 16; ++r) {
    const int row = warp * 16 + r, sq = q0 + row;
    if (sq >= Sq) break;
    const float l = l_s[row], m = m_s[row];
    const bool dead = (l == 0.0f) || (m <= kMask * 0.5f);
    const float inv = dead ? 0.0f : 1.0f / l;
    __nv_bfloat16* o = out + (static_cast<size_t>(b) * Sq + sq) * q_stride + h * D;
    for (int d = lane; d < D; d += 32) o[d] = __float2bfloat16_rn(Os[row * L::LDO + d] * inv);
    if (lane == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + sq] = dead ? -INFINITY : m + logf(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           const void* q_offset, const void* kv_lens, int B, int Sq, int Sk,
           int Hq, int Hk, float scale, int causal, int window, float softcap,
           cudaStream_t s) {
  constexpr int bytes = FlashSmem<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_lens), Sq, Sk, Hq, Hk, scale, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0 and softcap <= 0 mean "off". D is 32, 64 or 128.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, const void* q_offset,
                                const void* kv_lens, int B, int Sq, int Sk,
                                int Hq, int Hk, int D, float scale, int causal,
                                int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, lse, q_offset, kv_lens, B, Sq, Sk, Hq, Hk,
                        scale, causal, window, softcap, s);
    case 64:
      return launch<64>(q, k, v, out, lse, q_offset, kv_lens, B, Sq, Sk, Hq, Hk,
                        scale, causal, window, softcap, s);
    case 128:
      return launch<128>(q, k, v, out, lse, q_offset, kv_lens, B, Sq, Sk, Hq, Hk,
                         scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
