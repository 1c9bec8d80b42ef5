// K3, float32 instance: flash-attention forward, out and log-sum-exp, over
// bshd float32 tensors.
//
// Replaces llm_fp8_tpu/kernels/flash_attention.py::flash_attention (forward:
// _flash_fwd_call / _fwd_kernel) where q, k and v are float32, as the GPT-2
// and NeoX families serve them (their forwards compute in float32). The TPU
// kernel runs Q·Kᵀ and P·V in the operands' dtype (p is cast to V's dtype,
// which keeps it float32), so here both products are float32: float32
// scores, the online softmax, P kept in float32, float32 out and LSE.
// Features: causal with a per-batch q_offset, per-batch kv_lens, GQA through
// the head map (Falcon-7B's 71 q heads over 1 kv head), the logit scale
// (BTLM's 1/d), ALiBi slopes ([B, Hq], -slope·|q_pos - k_pos| before the
// mask) and attention dropout (the keep mask of dropout.cuh over (seed,
// b·Hq + h, q_pos, k_pos) applied to P before P·V, the kept entries times
// 1/(1 - rate); the row sum, and so the LSE, takes the undropped P, as the
// bf16 instance). Masked scores take the TPU kernel's finite MASK_VALUE;
// dead rows give out 0 and lse -inf. Head dims 32, 64, 80, 128 and 256.
//
// Bound on the H100: operations, 4·D FLOPs per live (query, key) pair. No
// wgmma takes float32, so the products run on mma.sync m16n8k8 TF32 with a
// 3xTF32 split (below): three TF32 products per float32 product, against
// the 495 TFLOP/s TF32 peak, i.e. 165 TFLOP/s of float32 products at best
// (Falcon-7B's 2048-token causal prefill, 71 heads of 64, is 38 GFLOP a
// layer, 0.23 ms at that rate; 0.57 ms at CUDA-core float32's 67 TFLOP/s).
//
// Design (a simple kernel that is right; not yet tuned):
// - Precision: 3xTF32 (tf32x3.cuh: each operand split into big and small
//   TF32 parts, three products), float32 to a few ulps; single-pass TF32
//   (the PASSES == 1 instance) is kept as the planted fault the checks must
//   catch. CUDA-core FFMA was the other design: exact float32, but 3x fewer
//   FLOPs a cycle than 3xTF32 on the tensor cores.
// - One block of 4 warps per (64 query rows, q head, batch row); each warp
//   owns 16 rows. Q is loaded once into shared memory; the block walks key
//   tiles of BN keys (64; 32 at D = 256) that hold a live key for some row,
//   each loaded by all threads (16-byte loads, rows past Sk as zeros) into
//   shared memory and used by the 4 warps. Several blocks share an SM
//   (4 at D = 64), which overlaps one block's loads with another's math.
// - Rows of Q, K and V in shared memory are D + 4 floats apart, which puts
//   the 32 lanes of every fragment load on 32 different banks.
// - S = Q·Kᵀ stays in the accumulator registers (rows g and g + 8 of the
//   warp's 16, columns 2t and 2t + 1 of each 8-key group, g = lane / 4,
//   t = lane % 4). The softmax runs there in the log2 domain, the row max
//   and sum over the 4 lanes of a quad. P·V reads P straight from those
//   registers as the A fragment: within an 8-key group, the A fragment's
//   column t is key 2t and its column t + 4 key 2t + 1, so V's B fragment is
//   read with the same key order (rows 2t and 2t + 1), and the sum over the
//   group is unchanged. O stays in registers.
// - Warps whose rows all precede a causal tile skip its products.
// - Dropout is a uniform runtime branch (drop.on()), so it adds no template
//   instance; its hash runs only when a rate is set.
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "fp8_ftz.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::load4;
using tf32x3::mma_f32;
using tf32x3::split;

constexpr int kBM = 64;  // query rows a block: 4 warps of 16
constexpr float kMask = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int BN = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int LD = D + 4;              // floats between shared-memory rows
  static constexpr int BYTES = (kBM + 2 * BN) * LD * 4;
};

template <int D, int PASSES>
__global__ void __launch_bounds__(128)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ q_offset,
                     const int* __restrict__ kv_lens, const float* __restrict__ alibi, int Sq,
                     int Sk, int Hq, int Hk, float scale, int causal, dropout::Params drop) {
  constexpr int BN = Cfg<D>::BN, LD = Cfg<D>::LD, V4 = D / 4, NT = BN / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBM * LD;
  float* vs = ks + BN * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heavy (late) tiles first
  const int kvh = h / (Hq / Hk);
  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t q_rs = static_cast<size_t>(Hq) * D, k_rs = static_cast<size_t>(Hk) * D;

  // Key tiles that can hold a live (q, k) pair for some row of the block.
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_off + min(q0 + kBM, Sq));
  const int ntiles = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;

  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < kBM * V4; i += 128) {
    const int r = i / V4, c = (i % V4) * 4;
    *reinterpret_cast<float4*>(qs + r * LD + c) =
        q0 + r < Sq ? load4(q + (static_cast<size_t>(b) * Sq + q0 + r) * q_rs + h * D + c)
                    : zero;
  }

  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const int pos0 = q_off + row0;
  const int warp_min = q_off + q0 + 16 * warp, warp_max = warp_min + 15;
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi != nullptr ? alibi[b * Hq + h] * kLog2e : 0.0f;
  const bool dropping = drop.on();
  const uint32_t h0 = drop.head(static_cast<uint32_t>(b * Hq + h));

  float o[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's reads (and Q's stores) are done
    for (int i = threadIdx.x; i < BN * V4; i += 128) {
      const int r = i / V4, c = (i % V4) * 4;
      float4 kv = zero, vv = zero;
      if (k0 + r < Sk) {
        const size_t off = (static_cast<size_t>(b) * Sk + k0 + r) * k_rs + kvh * D + c;
        kv = load4(k + off);
        vv = load4(v + off);
      }
      *reinterpret_cast<float4*>(ks + r * LD + c) = kv;
      *reinterpret_cast<float4*>(vs + r * LD + c) = vv;
    }
    __syncthreads();
    if (causal && k0 > warp_max) continue;  // no live key for any row of this warp

    // ---- S = Q·Kᵀ ----
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const float* qa = qs + (16 * warp + g) * LD + 8 * kk + t;
      uint32_t ab[4], as[4];
      split<PASSES>(qa[0], ab[0], as[0]);
      split<PASSES>(qa[8 * LD], ab[1], as[1]);
      split<PASSES>(qa[4], ab[2], as[2]);
      split<PASSES>(qa[8 * LD + 4], ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kb = ks + (8 * n + g) * LD + 8 * kk + t;
        uint32_t bb0, bs0, bb1, bs1;
        split<PASSES>(kb[0], bb0, bs0);
        split<PASSES>(kb[4], bb1, bs1);
        mma_f32<PASSES>(s[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }

    // ---- online softmax, log2 domain ----
    const bool need_mask = k0 + BN > kv_len || (causal && k0 + BN - 1 > warp_min);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * t + (e & 1), qp = pos0 + 8 * (e >> 1);
        float x = s[n][e] * scale2;
        if (slope2 != 0.0f) x = fmaf(-slope2, fabsf(static_cast<float>(qp - kp)), x);
        if (need_mask) {
          bool live = kp < kv_len;
          if (causal) live = live && kp <= qp;
          x = live ? x : kMask;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if (dropping) {  // P·V takes the kept entries, scaled; l the undropped row sum
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1), qp = pos0 + 8 * (e >> 1);
          s[n][e] = drop.keep(h0, qp, kp) ? s[n][e] * drop.scale : 0.0f;
        }
    }
#pragma unroll
    for (int c = 0; c < DT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] *= alpha[e >> 1];

    // ---- O += P·V, P from the score registers (keys 2t, 2t + 1 of a group) ----
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ab[4], as[4];
      tf32x3::c_as_a<PASSES>(s[n], ab, as);
      const float* vb = vs + (8 * n + 2 * t) * LD + g;
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        uint32_t bb0, bs0, bb1, bs1;
        split<PASSES>(vb[8 * c], bb0, bs0);
        split<PASSES>(vb[LD + 8 * c], bb1, bs1);
        mma_f32<PASSES>(o[c], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }

  // ---- epilogue: out = O / l (0 on dead rows), lse = m + log l ----
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const bool dead = (l[r] == 0.0f) || (m[r] <= kMask * 0.5f);
    const float inv = dead ? 0.0f : 1.0f / l[r];
    float* orow = out + (static_cast<size_t>(b) * Sq + row) * q_rs + h * D;
#pragma unroll
    for (int c = 0; c < DT; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c + 2 * t) =
          make_float2(o[c][2 * r] * inv, o[c][2 * r + 1] * inv);
    if (t == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] =
          dead ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
  }
}

// One launch's arguments.
struct Args {
  const float *q, *k, *v;
  float *out, *lse;
  const int *q_offset, *kv_lens;
  const float* alibi;
  int B, Sq, Sk, Hq, Hk;
  float scale;
  int causal;
  dropout::Params drop;
};

template <int D, int PASSES>
int launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = Cfg<D>::BYTES;
  // Set once per instance (a function-local static), not on every launch.
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid((a.Sq + kBM - 1) / kBM, a.Hq, a.B);
  flash_fwd_f32_kernel<D, PASSES><<<grid, 128, bytes, s>>>(
      a.q, a.k, a.v, a.out, a.lse, a.q_offset, a.kv_lens, a.alibi, a.Sq, a.Sk, a.Hq, a.Hk,
      a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(int passes, const Args& a, cudaStream_t s) {
  if (passes == 3) return launch<D, 3>(a, s);
  if (passes == 1) return launch<D, 1>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Sq, Hq, D], k/v [B, Sk, Hk, D] float32, contiguous and 16-byte
// aligned; out like q, lse [B, Hq, Sq]; q_offset and kv_lens int32 [B];
// alibi float32 [B, Hq] slopes or null. passes: 3 (3xTF32, float32
// accuracy) or 1 (single-pass TF32, the planted fault of the checks).
// drop_threshold 0 and drop_scale 1 mean no dropout (K3's arguments).
extern "C" int flash_fwd_f32_launch(const void* q, const void* k, const void* v, void* out,
                                    void* lse, const void* q_offset, const void* kv_lens,
                                    const void* alibi, int B, int Sq, int Sk, int Hq, int Hk,
                                    int D, float scale, int causal, int passes,
                                    int drop_threshold, int drop_seed, float drop_scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(q),        static_cast<const float*>(k),
               static_cast<const float*>(v),        static_cast<float*>(out),
               static_cast<float*>(lse),            static_cast<const int*>(q_offset),
               static_cast<const int*>(kv_lens),    static_cast<const float*>(alibi),
               B, Sq, Sk, Hq, Hk, scale, causal,
               dropout::Params{static_cast<uint32_t>(drop_threshold),
                               static_cast<uint32_t>(drop_seed), drop_scale}};
  switch (D) {
    case 32: return launch_d<32>(passes, a, s);
    case 64: return launch_d<64>(passes, a, s);
    case 80: return launch_d<80>(passes, a, s);
    case 128: return launch_d<128>(passes, a, s);
    case 256: return launch_d<256>(passes, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
