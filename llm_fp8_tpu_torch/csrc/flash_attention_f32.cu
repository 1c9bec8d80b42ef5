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
// Bound on the H100: operations, 4·D FLOPs per live (query, key) pair. The
// products run on the TF32 tensor cores (wgmma m64nNk8 .tf32) with a 3xTF32
// split (below): three TF32 products per float32 product, against the
// 495 TFLOP/s TF32 peak, i.e. 165 TFLOP/s of float32 products at best
// (Falcon-7B's 2048-token causal prefill, 71 heads of 64, is 38 GFLOP a
// layer, 0.23 ms at that rate; 0.57 ms at CUDA-core float32's 67 TFLOP/s).
//
// Design:
// - Precision: 3xTF32 (tf32x3.cuh: each operand split into big and small
//   TF32 parts, three products), float32 to a few ulps; single-pass TF32
//   (the PASSES == 1 instance) is kept as the planted fault the checks must
//   catch.
// - One block of two warpgroups (8 warps of 16 rows) per (128 query rows,
//   q head, batch row). Q is copied once into shared memory (rows D + 4
//   floats apart); each warp splits its own rows' A fragments a k-step at
//   a time, the next step's loads and split running while the last step's
//   wgmmas do. A warpgroup whose rows all precede a causal tile skips it.
// - The block walks key tiles of BN keys (Cfg) that hold a live key for
//   some row. Tile j + 1's K and V rows are in flight (cp.async, rows past
//   Sk as zeros) while tile j's products run; when they land, the split
//   stage writes K once into a plane (keys as rows: Q·Kᵀ's K-major B) and V
//   once, transposed, into another (head dims as rows, keys in the c_as_a
//   order: P·V's K-major B), and the wgmmas read those planes and convert
//   nothing. BN keeps two blocks on an SM up to D 80 (one at D 128 and 256),
//   so that one warpgroup's split and softmax run while another's products
//   do.
// - S = Q·Kᵀ stays in the accumulator registers (rows g and g + 8 of the
//   warp's 16, columns 2t and 2t + 1 of each 8-key group, g = lane / 4,
//   t = lane % 4). The softmax runs there in the log2 domain (p = 2^x by
//   the special-function unit, ex2.approx: about 2 ulp, results below
//   2^-126 flushed to 0), the row max and sum over the 4 lanes of a quad. P·V reads P straight from those
//   registers as the A fragment (tf32x3::c_as_a); V's plane holds the keys
//   of each 8-group in the matching order, so the sum over the group is
//   unchanged. O stays in registers (two 128-column wgmma halves at D 256).
// - Dropout is a uniform runtime branch (drop.on()), so it adds no template
//   instance; its hash runs only when a rate is set.
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "fp8_ftz.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kMask = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int NWG = 2;         // warpgroups a block, 64 query rows each
  static constexpr int BM = 64 * NWG;   // query rows a block
  static constexpr int NT = 128 * NWG;  // threads a block
  static constexpr int BN = D == 32 ? 64 : D <= 80 ? 32 : 16;  // keys a tile
  static constexpr int LD = D + 4;  // floats between the rows of Q and the raw K/V tiles
  // Q, the raw K and V tiles in flight, K's plane and V's transposed plane.
  static constexpr int BYTES =
      4 * (BM * LD + 2 * BN * LD + 2 * (2 * BN * D));
  static_assert(BYTES <= 232448, "K3 f32: shared memory");
};

template <int D, int PASSES>
__global__ void __launch_bounds__(Cfg<D>::NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, const int* __restrict__ q_offset,
                     const int* __restrict__ kv_lens, const float* __restrict__ alibi, int Sq,
                     int Sk, int Hq, int Hk, float scale, int causal, dropout::Params drop) {
  constexpr int BM = Cfg<D>::BM, NT = Cfg<D>::NT, BN = Cfg<D>::BN, LD = Cfg<D>::LD;
  constexpr int NG = BN / 8, DT = D / 8;  // 8-key groups a tile, 8-column groups of O
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kraw = qs + BM * LD;
  float* vraw = kraw + BN * LD;
  uint32_t* kpl = reinterpret_cast<uint32_t*>(vraw + BN * LD);  // BN keys x D
  uint32_t* vpl = kpl + 2 * BN * D;                              // D x BN keys

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy (late) tiles first
  const int kvh = h / (Hq / Hk);
  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lr0 = 64 * wg + 16 * warp + g;  // this thread's rows in the block: lr0, lr0 + 8
  const size_t q_rs = static_cast<size_t>(Hq) * D, k_rs = static_cast<size_t>(Hk) * D;
  const size_t kbase = static_cast<size_t>(b) * Sk;

  // Key tiles that can hold a live (q, k) pair for some row of the block.
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_off + min(q0 + BM, Sq));
  const int ntiles = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;

  tf32x3::cp_rows<D, BM, NT>(qs, q, q0, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
  if (ntiles > 0) {
    tf32x3::cp_rows<D, BN, NT>(kraw, k, 0, Sk, kbase, k_rs, kvh * D);
    tf32x3::cp_rows<D, BN, NT>(vraw, v, 0, Sk, kbase, k_rs, kvh * D);
  }
  tf32x3::cp_async_commit();

  const int row0 = q0 + lr0;  // this thread's rows: row0, row0 + 8
  const int pos0 = q_off + row0;
  const int warp_min = pos0 - g;
  // The last query position of this thread's warpgroup (its products skip
  // the key tiles past it) and whether the warpgroup has rows at all.
  const int wg_max = q_off + q0 + 64 * wg + 63;
  const bool wg_rows = q0 + 64 * wg < Sq;
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi != nullptr ? alibi[b * Hq + h] * kLog2e : 0.0f;
  const bool dropping = drop.on();
  const uint32_t h0 = drop.head(static_cast<uint32_t>(b * Hq + h));

  float o[D / 2];  // 8-column group c: o[4c .. 4c + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN;
    tf32x3::cp_async_wait_all();
    __syncthreads();  // tile j (and Q) landed; the previous tile's products are done
    tf32x3::split_plane<PASSES, BN, D, NT>(kpl, kraw);
    tf32x3::split_plane_t<PASSES, BN, D, NT>(vpl, vraw);
    hopper::fence_proxy_async();  // the planes, written by threads, are read by wgmma
    __syncthreads();              // the planes are written and the raw tiles free
    if (j + 1 < ntiles) {
      tf32x3::cp_rows<D, BN, NT>(kraw, k, k0 + BN, Sk, kbase, k_rs, kvh * D);
      tf32x3::cp_rows<D, BN, NT>(vraw, v, k0 + BN, Sk, kbase, k_rs, kvh * D);
    }
    tf32x3::cp_async_commit();
    // A warpgroup whose rows all precede the tile (or lie past Sq) skips it.
    if ((causal && k0 > wg_max) || !wg_rows) continue;

    // ---- S = Q·Kᵀ (8-key group n: s[4n .. 4n + 3]) ----
    float sacc[1][BN / 2];
    float (&s)[BN / 2] = sacc[0];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.0f;
    tf32x3::rows_products<PASSES, BN, D, 1>(sacc, {qs}, lr0, t, {kpl});

    // ---- online softmax, log2 domain ----
    const bool need_mask = k0 + BN > kv_len || (causal && k0 + BN - 1 > warp_min);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * t + (e & 1), qp = pos0 + 8 * (e >> 1);
        float x = s[4 * n + e] * scale2;
        if (slope2 != 0.0f) x = fmaf(-slope2, fabsf(static_cast<float>(qp - kp)), x);
        if (need_mask) {
          bool live = kp < kv_len;
          if (causal) live = live && kp <= qp;
          x = live ? x : kMask;
        }
        s[4 * n + e] = x;
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
    for (int i = 0; i < BN / 2; ++i) {
      const float p = hopper::fast_exp2(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      rs[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if (dropping) {  // P·V takes the kept entries, scaled; l the undropped row sum
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1), qp = pos0 + 8 * (e >> 1);
          s[4 * n + e] = drop.keep(h0, qp, kp) ? s[4 * n + e] * drop.scale : 0.0f;
        }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // ---- O += P·V, P from the score registers (keys 2t, 2t + 1 of a group) ----
    uint32_t pb[NG][4], ps[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n) tf32x3::c_as_a<PASSES>(s + 4 * n, pb[n], ps[n]);
    if constexpr (D <= 128) {
      tf32x3::acc_product<PASSES, D, BN, D>(o, pb, ps, vpl, 0, 1);
    } else {  // two 128-column halves (one wgmma's N at most 256, its registers 128)
      tf32x3::acc_product<PASSES, 128, BN, D>(*reinterpret_cast<float(*)[64]>(o), pb, ps,
                                              vpl, 0, 1);
      tf32x3::acc_product<PASSES, 128, BN, D>(*reinterpret_cast<float(*)[64]>(o + 64), pb,
                                              ps, vpl, 128, 1);
    }
  }
  tf32x3::cp_async_wait_all();  // no copy outlives the block

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
          make_float2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
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
  dim3 grid((a.Sq + Cfg<D>::BM - 1) / Cfg<D>::BM, a.Hq, a.B);
  flash_fwd_f32_kernel<D, PASSES><<<grid, Cfg<D>::NT, bytes, s>>>(
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
