// K6, float32 instance: flash-attention backward, dQ and dK/dV, over bshd
// float32 tensors.
//
// Replaces llm_fp8_tpu/kernels/flash_attention_bwd.py::flash_attention_bwd
// (_dkv_kernel, _dq_kernel, _recompute_p_and_ds) where q, k and v are
// float32, as the GPT-2 and NeoX families train them (their forwards compute
// in float32). The TPU kernel rounds p and ds to q's dtype before the dV, dK
// and dQ products, which keeps them float32 here. Per tile, in float32:
//   z  = scale·QKᵀ - slope·|q_pos - k_pos|,  masked as K3
//   p  = exp(z - lse) on live pairs of rows with a finite lse, else 0
//   ds = p·(dO·Vᵀ - di)·scale,  di = rowsum(o·dO)
//   dV += pᵀ·dO,  dK += dsᵀ·Q,  dQ += ds·K
// from K3's [B, Hq, Sq] log-sum-exp, so no [Sq, Sk] matrix reaches device
// memory. Features: causal with a per-batch q_offset, kv_lens, GQA (the
// dKV kernel sums the group in float32), the logit scale (BTLM's 1/d),
// ALiBi slopes ([B, Hq]) and attention dropout: the forward's keep mask
// rebuilt from dropout.cuh; the kept p times 1/(1 - rate) feeds dV, dP is
// masked and scaled alike, and ds takes the undropped p (the bf16 K6's
// chain). Window and softcap are not taken (no GPT-2/NeoX model has them):
// the wrapper raises. Head dims 32, 64, 80, 128 and 256.
//
// Bound on the H100: operations. Five products per live (query, key) pair
// (the S recompute, dP, dV, dK, dQ), 10·D FLOPs, each run as three TF32
// products (3xTF32, tf32x3.cuh) against the 495 TFLOP/s TF32 peak. At
// BTLM-3B's training shape (B 8, S 512, 32 heads of 80, causal) that is
// 2.7e10 float32 FLOPs a layer, 163 µs at that rate.
//
// Design (a simple kernel that is right; not yet tuned), two kernels with
// no atomics, so two runs give the same bits:
//   dQ:  launched first. One block of 4 warps per (64 query rows, q head,
//        batch row), each warp owning 16 rows; Q and dO are loaded once into
//        shared memory, and each thread first sums di = rowsum(o·dO) for its
//        two rows (a quarter of the row per lane, then the quad) and writes
//        it for the dKV kernel. The block walks the key tiles K3 walks
//        (64 keys; 32 at D 256), loading K and V synchronously; S = Q·Kᵀ and
//        dP = dO·Vᵀ stay in the accumulator registers, ds is formed there,
//        and dQ += ds·K reads ds as the A fragment in place (tf32x3::c_as_a)
//        with K read in the same key order. dQ stays in registers.
//   dKV: one block of 4 warps per (64 keys, kv head, batch row), each warp
//        owning 16 keys; K and V are loaded once. The block walks the q heads
//        of the GQA group and, for each, the query tiles that can reach its
//        keys (32 or 64 queries), loading Q, dO, the tile's lse and di.
//        Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys as rows) stay in registers, pᵀ and
//        dsᵀ are formed there and feed dV += pᵀ·dO and dK += dsᵀ·Q as A
//        fragments in place. At D >= 128, where dK and dV would take D
//        registers a thread together, a block computes one of them (grid x
//        doubled: odd blocks dK, even blocks dV).
// dQ, dK and dV are sums over thousands of products: each tile's share is
// summed in the tensor cores from zero and added to the running float32 sum
// with a rounding add (flush below: the tensor cores' accumulation drops low
// bits, and a sum carried through them drifts). Rows of every tile are D + 4
// floats apart in shared memory, which puts the 32 lanes of every fragment
// load on 32 banks. Warps whose rows lie
// wholly outside a causal tile skip its products.
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "fp8_ftz.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::a_frag;
using tf32x3::c_as_a;
using tf32x3::load4;
using tf32x3::mma_f32;
using tf32x3::split;

constexpr int kBM = 64;  // rows a block (queries in dQ, keys in dKV): 4 warps of 16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;               // floats between shared-memory rows
  static constexpr int BN = D > 128 ? 32 : 64;   // dQ: keys a tile
  static constexpr int BQ = D > 64 ? 32 : 64;    // dKV: queries a tile
  static constexpr bool SPLIT = D >= 128;        // dKV: dK and dV in separate blocks
  static constexpr int DQ_BYTES = (2 * kBM + 2 * BN) * LD * 4;
  static constexpr int DKV_BYTES = (2 * kBM + 2 * BQ) * LD * 4 + 2 * BQ * 4;
};

// A row's lse as the kernels use it: -lse·log2(e), or -inf for a dead row
// (lse -inf), so that p = 2^(z·log2(e) - lse·log2(e)) is 0 there.
__device__ __forceinline__ float neg_lse2(float lse) {
  return isfinite(lse) ? -lse * kLog2e : -INFINITY;
}

// p of one (query, key) pair from its raw score s (the Q·Kᵀ product), or 0
// off the live pairs.
__device__ __forceinline__ float prob(float s, float scale2, float nl, float slope2, int qp,
                                      int kp, int kv_len, int causal) {
  const bool live = kp < kv_len && (!causal || kp <= qp);
  if (!live) return 0.0f;
  float x = fmaf(s, scale2, nl);
  if (slope2 != 0.0f) x = fmaf(-slope2, fabsf(static_cast<float>(qp - kp)), x);
  return exp2f(x);
}

// acc += part with a rounding float32 add. The tensor cores' float32
// accumulation does not round to nearest (it drops the low bits), so a sum
// carried through thousands of mma steps drifts toward zero: ~2^-12 of dK
// and dV after Falcon-7B's 71 q heads x 300 queries on an H100. Each tile's
// product therefore starts from zero in the tensor cores (tens of steps)
// and is added to the running sum here.
__device__ __forceinline__ void flush(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// acc[c] += a·b over one tile for every 8-column group c of the output:
// a is NN accumulator tiles (rows: this warp's 16; k: the tile's 8·NN
// positions in the c_as_a order), b the tile's rows in shared memory (LD
// floats apart, k as rows); each group's product summed from zero and
// flushed.
template <int PASSES, int NN, int DT, int LD>
__device__ __forceinline__ void tile_product(float (&acc)[DT][4], const float (&a)[NN][4],
                                             const float* b, int g, int t) {
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t ab[4], as[4], bb0, bs0, bb1, bs1;
      c_as_a<PASSES>(a[n], ab, as);
      const float* bp = b + (8 * n + 2 * t) * LD + g + 8 * c;
      split<PASSES>(bp[0], bb0, bs0);
      split<PASSES>(bp[LD], bb1, bs1);
      mma_f32<PASSES>(part, ab, as, bb0, bb1, bs0, bs1);
    }
    flush(acc[c], part);
  }
}

// Loads rows r0..r0 + rows - 1 (of n) of one head of a bshd tensor
// (row stride rs floats, head offset ho) into shared memory rows LD apart;
// rows past n as zeros.
template <int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int rows, int n,
                                          size_t base, size_t rs, size_t ho) {
  constexpr int V4 = D / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < rows * V4; i += 128) {
    const int r = i / V4, c = (i % V4) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        r0 + r < n ? load4(src + (base + r0 + r) * rs + ho + c) : zero;
  }
}

template <int D, int PASSES>
__global__ void __launch_bounds__(128)
flash_bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ di_out, const int* __restrict__ q_offset,
                        const int* __restrict__ kv_lens, float* __restrict__ dq,
                        const float* __restrict__ alibi, int Sq, int Sk, int Hq, int Hk,
                        float scale, int causal, dropout::Params drop) {
  constexpr int BN = Cfg<D>::BN, LD = Cfg<D>::LD, V4 = D / 4, NT = BN / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBM * LD;
  float* ks = dos + kBM * LD;
  float* vs = ks + BN * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heavy (late) tiles first
  const int kvh = h / (Hq / Hk);
  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t q_rs = static_cast<size_t>(Hq) * D, k_rs = static_cast<size_t>(Hk) * D;
  const size_t bh = static_cast<size_t>(b) * Hq + h;

  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_off + min(q0 + kBM, Sq));
  const int ntiles = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;

  load_rows<D, LD>(qs, q, q0, kBM, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
  load_rows<D, LD>(dos, dout, q0, kBM, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
  __syncthreads();

  // di = rowsum(o·dO) for this thread's rows (local 16·warp + g and + 8):
  // lane t of the quad sums the float4 chunks t, t + 4, ... of the row.
  const int lr0 = 16 * warp + g;
  float di[2], nl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr0 + 8 * r;
    float sum = 0.0f;
    if (row < Sq) {
      const float* orow = o + (static_cast<size_t>(b) * Sq + row) * q_rs + h * D;
      const float* drow = dos + (lr0 + 8 * r) * LD;
      for (int c4 = t; c4 < V4; c4 += 4) {
        const float4 a = load4(orow + 4 * c4), d = load4(drow + 4 * c4);
        sum = fmaf(a.x, d.x, sum);
        sum = fmaf(a.y, d.y, sum);
        sum = fmaf(a.z, d.z, sum);
        sum = fmaf(a.w, d.w, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    di[r] = sum;
    nl[r] = row < Sq ? neg_lse2(lse[bh * Sq + row]) : -INFINITY;
    if (row < Sq && t == 0) di_out[bh * Sq + row] = sum;
  }

  const int pos0 = q_off + q0 + lr0;  // this thread's query positions: pos0, pos0 + 8
  const int warp_max = q_off + q0 + 16 * warp + 15;
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi != nullptr ? alibi[bh] * kLog2e : 0.0f;
  const bool dropping = drop.on();
  const uint32_t h0 = drop.head(static_cast<uint32_t>(bh));

  float acc[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's reads are done
    load_rows<D, LD>(ks, k, k0, BN, Sk, static_cast<size_t>(b) * Sk, k_rs, kvh * D);
    load_rows<D, LD>(vs, v, k0, BN, Sk, static_cast<size_t>(b) * Sk, k_rs, kvh * D);
    __syncthreads();
    if (causal && k0 > warp_max) continue;  // no live key for any row of this warp

    // ---- S = Q·Kᵀ and dP = dO·Vᵀ ----
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t qb[4], qsm[4], db[4], dsm[4];
      a_frag<PASSES>(qs + lr0 * LD + 8 * kk + t, LD, qb, qsm);
      a_frag<PASSES>(dos + lr0 * LD + 8 * kk + t, LD, db, dsm);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kb = ks + (8 * n + g) * LD + 8 * kk + t;
        const float* vb = vs + (8 * n + g) * LD + 8 * kk + t;
        uint32_t bb0, bs0, bb1, bs1;
        split<PASSES>(kb[0], bb0, bs0);
        split<PASSES>(kb[4], bb1, bs1);
        mma_f32<PASSES>(s[n], qb, qsm, bb0, bb1, bs0, bs1);
        split<PASSES>(vb[0], bb0, bs0);
        split<PASSES>(vb[4], bb1, bs1);
        mma_f32<PASSES>(dp[n], db, dsm, bb0, bb1, bs0, bs1);
      }
    }

    // ---- ds = p·(dP - di)·scale, in place of S ----
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kp = k0 + 8 * n + 2 * t + (e & 1), qp = pos0 + 8 * r;
        const float p = prob(s[n][e], scale2, nl[r], slope2, qp, kp, kv_len, causal);
        float d = dp[n][e];
        if (dropping) d = drop.keep(h0, qp, kp) ? d * drop.scale : 0.0f;
        s[n][e] = p * (d - di[r]) * scale;
      }

    // ---- dQ += ds·K, ds from the score registers (keys 2t, 2t + 1) ----
    tile_product<PASSES, NT, DT, LD>(acc, s, ks, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr0 + 8 * r;
    if (row >= Sq) continue;
    float* drow = dq + (static_cast<size_t>(b) * Sq + row) * q_rs + h * D;
#pragma unroll
    for (int c = 0; c < DT; ++c)
      *reinterpret_cast<float2*>(drow + 8 * c + 2 * t) =
          make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
  }
}

// The dKV block's walk: dK (DO_DK) and/or dV (DO_DV) of 64 keys from key
// k0 of kv head kvh, batch row b, over the group's q heads and the query
// tiles that reach the keys.
template <int D, int PASSES, bool DO_DK, bool DO_DV>
__device__ __forceinline__ void dkv_block(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di_in, const int* __restrict__ q_offset,
    const int* __restrict__ kv_lens, float* __restrict__ dk, float* __restrict__ dv,
    const float* __restrict__ alibi, int k0, int kvh, int b, int Sq, int Sk, int Hq, int Hk,
    float scale, int causal, const dropout::Params& drop) {
  constexpr int BQ = Cfg<D>::BQ, LD = Cfg<D>::LD, NQ = BQ / 8, DT = D / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBM * LD;
  float* qs = vs + kBM * LD;
  float* dos = qs + BQ * LD;
  float* nls = dos + BQ * LD;  // the tile's -lse·log2(e)
  float* dis = nls + BQ;       // the tile's di

  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);
  const int group = Hq / Hk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t q_rs = static_cast<size_t>(Hq) * D, k_rs = static_cast<size_t>(Hk) * D;
  const int lr0 = 16 * warp + g;
  const int kp0 = k0 + lr0;  // this thread's keys: kp0, kp0 + 8
  const int warp_kmin = k0 + 16 * warp;
  const float scale2 = scale * kLog2e;
  const bool dropping = drop.on();

  load_rows<D, LD>(ks, k, k0, kBM, Sk, static_cast<size_t>(b) * Sk, k_rs, kvh * D);
  if (DO_DK) load_rows<D, LD>(vs, v, k0, kBM, Sk, static_cast<size_t>(b) * Sk, k_rs, kvh * D);

  // The dK and dV accumulators (the one a block does not compute is dead
  // code the compiler drops).
  float gk[DT][4], gv[DT][4];
#pragma unroll
  for (int c = 0; c < DT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[c][e] = gv[c][e] = 0.0f;

  // Query tiles that can reach a live key of the block.
  const int qt0 = causal ? max(0, k0 - q_off) / BQ : 0;
  const int qt1 = k0 < kv_len ? (Sq + BQ - 1) / BQ : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const size_t bh = static_cast<size_t>(b) * Hq + h;
    const float slope2 = alibi != nullptr ? alibi[bh] * kLog2e : 0.0f;
    const uint32_t h0 = drop.head(static_cast<uint32_t>(bh));
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's reads are done (and K/V's stores)
      load_rows<D, LD>(qs, q, q0, BQ, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
      load_rows<D, LD>(dos, dout, q0, BQ, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
      for (int i = threadIdx.x; i < BQ; i += 128) {
        const bool in = q0 + i < Sq;
        nls[i] = in ? neg_lse2(lse[bh * Sq + q0 + i]) : -INFINITY;
        dis[i] = in ? di_in[bh * Sq + q0 + i] : 0.0f;
      }
      __syncthreads();
      // No live pair for any key of this warp: all its keys follow every
      // query of the tile, or lie past kv_len.
      if ((causal && warp_kmin > q_off + q0 + BQ - 1) || warp_kmin >= kv_len) continue;

      // ---- Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys as rows) ----
      float st[NQ][4], dpt[NQ][4];  // dpt: dK's only
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        uint32_t kb[4], ksm[4], vb[4], vsm[4];
        a_frag<PASSES>(ks + lr0 * LD + 8 * kk + t, LD, kb, ksm);
        if (DO_DK) a_frag<PASSES>(vs + lr0 * LD + 8 * kk + t, LD, vb, vsm);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const float* qb = qs + (8 * n + g) * LD + 8 * kk + t;
          uint32_t bb0, bs0, bb1, bs1;
          split<PASSES>(qb[0], bb0, bs0);
          split<PASSES>(qb[4], bb1, bs1);
          mma_f32<PASSES>(st[n], kb, ksm, bb0, bb1, bs0, bs1);
          if (DO_DK) {
            const float* db = dos + (8 * n + g) * LD + 8 * kk + t;
            split<PASSES>(db[0], bb0, bs0);
            split<PASSES>(db[4], bb1, bs1);
            mma_f32<PASSES>(dpt[n], vb, vsm, bb0, bb1, bs0, bs1);
          }
        }
      }

      // ---- pᵀ (dropped and scaled for dV) in place of Sᵀ, dsᵀ in place of dPᵀ ----
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * t + (e & 1), kp = kp0 + 8 * (e >> 1);
          const int qp = q_off + q0 + qi;
          const float p = prob(st[n][e], scale2, nls[qi], slope2, qp, kp, kv_len, causal);
          const bool keep = !dropping || drop.keep(h0, qp, kp);
          if (DO_DK) {
            const float d = keep ? dpt[n][e] * drop.scale : 0.0f;
            dpt[n][e] = p * (d - dis[qi]) * scale;
          }
          st[n][e] = keep ? p * drop.scale : 0.0f;
        }

      // ---- dV += pᵀ·dO and dK += dsᵀ·Q (queries 2t, 2t + 1 of each group) ----
      if (DO_DV) tile_product<PASSES, NQ, DT, LD>(gv, st, dos, g, t);
      if (DO_DK) tile_product<PASSES, NQ, DT, LD>(gk, dpt, qs, g, t);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kp0 + 8 * r;
    if (key >= Sk) continue;
    const size_t off = (static_cast<size_t>(b) * Sk + key) * k_rs + kvh * D;
    if (DO_DK) {
#pragma unroll
      for (int c = 0; c < DT; ++c)
        *reinterpret_cast<float2*>(dk + off + 8 * c + 2 * t) =
            make_float2(gk[c][2 * r], gk[c][2 * r + 1]);
    }
    if (DO_DV) {
#pragma unroll
      for (int c = 0; c < DT; ++c)
        *reinterpret_cast<float2*>(dv + off + 8 * c + 2 * t) =
            make_float2(gv[c][2 * r], gv[c][2 * r + 1]);
    }
  }
}

template <int D, int PASSES>
__global__ void __launch_bounds__(128)
flash_bwd_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const float* __restrict__ alibi, int Sq, int Sk, int Hq, int Hk,
                         float scale, int causal, dropout::Params drop) {
  // Low key tiles, which the most queries reach, first.
  const int kvh = blockIdx.y, b = blockIdx.z;
  if (Cfg<D>::SPLIT) {
    const int k0 = (blockIdx.x >> 1) * kBM;
    if (blockIdx.x & 1)
      dkv_block<D, PASSES, true, false>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv,
                                        alibi, k0, kvh, b, Sq, Sk, Hq, Hk, scale, causal, drop);
    else
      dkv_block<D, PASSES, false, true>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv,
                                        alibi, k0, kvh, b, Sq, Sk, Hq, Hk, scale, causal, drop);
  } else {
    dkv_block<D, PASSES, true, true>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, alibi,
                                     blockIdx.x * kBM, kvh, b, Sq, Sk, Hq, Hk, scale, causal,
                                     drop);
  }
}

// One launch's arguments.
struct Args {
  const float* alibi;
  int B, Sq, Sk, Hq, Hk;
  float scale;
  int causal;
  dropout::Params drop;
};

template <int D, int PASSES>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* di, const int* q_offset,
              const int* kv_lens, float* dq, const Args& a, cudaStream_t s) {
  constexpr int bytes = Cfg<D>::DQ_BYTES;
  // Set once per instance (a function-local static), not on every launch.
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_bwd_f32_dq_kernel<D, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid((a.Sq + kBM - 1) / kBM, a.Hq, a.B);
  flash_bwd_f32_dq_kernel<D, PASSES><<<grid, 128, bytes, s>>>(
      q, k, v, o, dout, lse, di, q_offset, kv_lens, dq, a.alibi, a.Sq, a.Sk, a.Hq, a.Hk,
      a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int PASSES>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* di, const int* q_offset, const int* kv_lens,
               float* dk, float* dv, const Args& a, cudaStream_t s) {
  constexpr int bytes = Cfg<D>::DKV_BYTES;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_bwd_f32_dkv_kernel<D, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  const int tiles = (a.Sk + kBM - 1) / kBM;
  dim3 grid(Cfg<D>::SPLIT ? 2 * tiles : tiles, a.Hk, a.B);
  flash_bwd_f32_dkv_kernel<D, PASSES><<<grid, 128, bytes, s>>>(
      q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, a.alibi, a.Sq, a.Sk, a.Hq, a.Hk,
      a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* alibi, int B, int Sq, int Sk, int Hq, int Hk, float scale,
               int causal, int drop_threshold, int drop_seed, float drop_scale) {
  return Args{static_cast<const float*>(alibi), B, Sq, Sk, Hq, Hk, scale, causal,
              dropout::Params{static_cast<uint32_t>(drop_threshold),
                              static_cast<uint32_t>(drop_seed), drop_scale}};
}

}  // namespace

#define K6F_F(p) static_cast<const float*>(p)
#define K6F_I(p) static_cast<const int*>(p)

// q, o, dout [B, Sq, Hq, D], k, v [B, Sk, Hk, D] float32, contiguous and
// 16-byte aligned; lse and di float32 [B, Hq, Sq]; q_offset and kv_lens int32
// [B]; alibi float32 [B, Hq] slopes or null; drop_threshold 0 and
// drop_scale 1 mean no dropout (K3's arguments). passes: 3 (3xTF32) or 1
// (single-pass TF32, the planted fault of the checks). The dQ kernel writes
// dq and di, which the dKV kernel reads: launch dQ first.
extern "C" int flash_bwd_f32_dq_launch(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* di, const void* q_offset, const void* kv_lens,
                                       void* dq, const void* alibi, int B, int Sq, int Sk,
                                       int Hq, int Hk, int D, float scale, int causal,
                                       int passes, int drop_threshold, int drop_seed,
                                       float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(alibi, B, Sq, Sk, Hq, Hk, scale, causal, drop_threshold, drop_seed,
                           drop_scale);
  if (passes != 1 && passes != 3) return static_cast<int>(cudaErrorInvalidValue);
#define K6F_DQ(DD)                                                                        \
  return passes == 3                                                                      \
             ? launch_dq<DD, 3>(K6F_F(q), K6F_F(k), K6F_F(v), K6F_F(o), K6F_F(dout),      \
                                K6F_F(lse), static_cast<float*>(di), K6F_I(q_offset),     \
                                K6F_I(kv_lens), static_cast<float*>(dq), a, s)            \
             : launch_dq<DD, 1>(K6F_F(q), K6F_F(k), K6F_F(v), K6F_F(o), K6F_F(dout),      \
                                K6F_F(lse), static_cast<float*>(di), K6F_I(q_offset),     \
                                K6F_I(kv_lens), static_cast<float*>(dq), a, s)
  switch (D) {
    case 32: K6F_DQ(32);
    case 64: K6F_DQ(64);
    case 80: K6F_DQ(80);
    case 128: K6F_DQ(128);
    case 256: K6F_DQ(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6F_DQ
}

extern "C" int flash_bwd_f32_dkv_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* di,
                                        const void* q_offset, const void* kv_lens, void* dk,
                                        void* dv, const void* alibi, int B, int Sq, int Sk,
                                        int Hq, int Hk, int D, float scale, int causal,
                                        int passes, int drop_threshold, int drop_seed,
                                        float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(alibi, B, Sq, Sk, Hq, Hk, scale, causal, drop_threshold, drop_seed,
                           drop_scale);
  if (passes != 1 && passes != 3) return static_cast<int>(cudaErrorInvalidValue);
#define K6F_DKV(DD)                                                                       \
  return passes == 3                                                                      \
             ? launch_dkv<DD, 3>(K6F_F(q), K6F_F(k), K6F_F(v), K6F_F(dout), K6F_F(lse),   \
                                 K6F_F(di), K6F_I(q_offset), K6F_I(kv_lens),              \
                                 static_cast<float*>(dk), static_cast<float*>(dv), a, s)  \
             : launch_dkv<DD, 1>(K6F_F(q), K6F_F(k), K6F_F(v), K6F_F(dout), K6F_F(lse),   \
                                 K6F_F(di), K6F_I(q_offset), K6F_I(kv_lens),              \
                                 static_cast<float*>(dk), static_cast<float*>(dv), a, s)
  switch (D) {
    case 32: K6F_DKV(32);
    case 64: K6F_DKV(64);
    case 80: K6F_DKV(80);
    case 128: K6F_DKV(128);
    case 256: K6F_DKV(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6F_DKV
}
