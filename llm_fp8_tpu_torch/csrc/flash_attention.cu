// K3: flash-attention forward, out and log-sum-exp, over bshd bf16 tensors.
//
// Replaces llm_fp8_tpu/kernels/flash_attention.py::flash_attention (forward:
// _flash_fwd_call / _fwd_kernel). Features: causal with a per-batch q_offset,
// per-batch kv_lens, GQA through the head map (K/V are never repeated),
// sliding window, softcap, the logit scale, ALiBi, attention dropout,
// segment ids and attention_chunk.
// Masked scores take the TPU kernel's finite MASK_VALUE; dead rows (no live
// key) give out 0 and lse -inf, as on the TPU. P is rounded to bf16 before
// the P·V product.
// - ALiBi: -slope·|q_pos - k_pos| on absolute positions (q_pos = q_offset +
//   row), added after softcap and before the mask, per [B, Hq] slope. The
//   softmax runs in the log2 domain, so the bias is scaled by log2(e) with
//   the scores; the LSE stays in natural units.
// - Dropout: the keep mask of dropout.cuh over (seed, b·Hq + h, q_pos,
//   k_pos); the row sum l (and so the LSE) takes the undropped p, P·V the
//   kept p times 1/(1 - rate), as the TPU kernel.
// Both take the kernel's EXTRA instance, so the plain causal path's code is
// the one without them.
// - Segment ids (packed sequences) and attention_chunk (Llama-4's chunked
//   attention): hopper.cuh's SegChunk, in the MASKS instance (MODE 2, which
//   takes ALiBi and dropout too), so neither of the others carries their
//   code. Each consumer thread reads its two rows' q ids and chunk starts
//   once (RowsLive) and, on every tile, the kv id of each of its columns
//   (the accumulator's 8·(i / 4) + 2·quad + (i & 1)) from global memory;
//   the chunk test goes beside the causal and window tests. Tiles outside
//   every row's chunk are never loaded (the TPU kernel's dead-tile rule);
//   with ids every tile takes the mask test. Negative q offsets (split-KV's
//   later chunks) leave rows with no live key: out 0, lse -inf.
//
// Bound on the H100: operations at long prompts, 4·D FLOPs per live (query,
// key) pair at 989 TFLOP/s bf16 (an 8192-token causal prefill of
// Llama-3.2-1B, 32 heads of 64, is 275 GFLOP a layer, 0.28 ms); at the
// 128-token serving bucket (67 MFLOP) launch and tile latency, a few µs.
//
// Design:
// - One block per (query tile, q head, batch row): one producer warpgroup
//   and NC consumer warpgroups of 64 query rows each. NC is 2 (128 rows)
//   when the grid still covers the SMs, else 1 (short prompts, and D >= 128,
//   whose S, P and O do not fit the registers of a 384-thread block).
// - The key tile is BN keys: 128, or 64 at D = 256 (Gemma-2), where Q and a
//   2-stage ring of 128-key K and V tiles (288 KB) exceed shared memory and
//   O alone takes 128 registers a thread (64 x 256 float32 a warpgroup):
//   with 64-key tiles the ring is 4 x 32 KB (160 KB with Q), S is a m64n64
//   accumulator (32 registers) and P·V runs as 4 k-steps over V's four
//   64-column chunks.
// - The producer's one thread loads Q once and the BN-key K and V tiles
//   through TMA (a 4-D tensor map over [B, S, H, D]; rows past S arrive as
//   zeros) into a 2-stage ring in swizzled shared memory, with full and
//   empty mbarriers, so the next tile's copy overlaps this tile's math.
// - Consumers: S = Q·Kᵀ on wgmma m64nBNk16 with both operands in shared
//   memory (SS, both K-major as stored); S stays in the accumulator
//   registers. Scale, softcap and masks are applied there, and the online
//   softmax runs in the log2 domain (one ex2 per score, log2(e) folded into
//   the scale) with the row max and sum over the 4 lanes of a quad. P is
//   converted in registers to bf16 A fragments and O += P·V runs on wgmma
//   with A in registers (RS) and V in shared memory MN-major (as stored, no
//   transpose). O stays in registers and is rescaled there; nothing float32
//   goes through shared memory. Within a warpgroup, S of the next tile is
//   issued before P·V of this one, and the next softmax runs while P·V
//   does; the two warpgroups interleave on the tensor cores besides.
// - The block walks the key tiles that hold a live key for some row (dead
//   tiles are never loaded). Masks are evaluated only on tiles that cut the
//   causal diagonal, kv_len or the window. With causal masking the heavy
//   query tiles (the last) are scheduled first.
#include <math.h>

#include "dropout.cuh"
#include "fp8_ftz.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int kStages = 2;
constexpr float kMask = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// The key tile: 128 keys, 64 at D = 256 (see the design note).
template <int D>
constexpr int key_tile() {
  return D == 256 ? 64 : 128;
}

template <int D, int NC>
struct FwdSmem {
  static constexpr int BN = key_tile<D>();
  static constexpr int QB = NC * 64 * D * 2;  // Q [NC·64][D]
  static constexpr int KB = BN * D * 2;       // one K or V tile [BN][D]
  static constexpr int Q = 0;
  static constexpr int K = Q + QB;
  static constexpr int V = K + kStages * KB;
  static constexpr int BAR = V + kStages * KB;  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

// The online softmax of one consumer thread's two rows (row and row + 8 of
// its warp's 16) over one BN-key tile of scores held as a m64nBN
// accumulator, in the log2 domain. EXTRA: ALiBi and dropout may be on. The
// MASKS instance takes the second softmax, the same code with an `extra`
// mask (RowsLive) beside the causal and window tests. The other instances
// keep the first: one softmax for all, given a mask that folds away
// (AllLive), left the same function but changed ptxas's register
// allocation of the existing instances (D 128's EXTRA one spilled and ran
// 11% slower on the H100), so they keep the code they had.
template <bool EXTRA, int BN>
struct Rows {
  float scale, softcap;
  int causal, window, kv_len;
  int q_pos;   // position of the thread's first row (the second is + 8)
  int wg_min;  // position of the warpgroup's first row (its last is + 63)
  int quad;    // lane % 4: the thread's columns are 8·(i / 4) + 2·quad + (i & 1)
  float slope2;          // ALiBi slope · log2(e) (0: no bias)
  dropout::Params drop;  // off unless EXTRA
  uint32_t h0;           // drop.head(b·Hq + h)

  // Scales (and caps), biases and masks sc in place, updates the running max
  // m and sum l, leaves p = 2^(x - m) in sc (dropped and scaled under
  // dropout) and the factor alpha by which the output accumulator must be
  // rescaled.
  __device__ __forceinline__ void softmax(float (&sc)[BN / 2], int k0, float (&m)[2],
                                          float (&l)[2], float (&alpha)[2]) const {
    const float scale2 = scale * kLog2e;
    const bool need_mask = k0 + BN > kv_len || (causal && k0 + BN - 1 > wg_min) ||
                           (window > 0 && k0 <= wg_min + 63 - window);
    float mx[2] = {-INFINITY, -INFINITY};
    // Unmasked, uncapped, unbiased tiles (most of a long prompt) take the max
    // of the raw scores and fold the scale into the exponent's multiply-add.
    const bool fold = !need_mask && softcap <= 0.0f && scale2 > 0.0f && (!EXTRA || slope2 == 0.0f);
    if (fold) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] *= scale2;
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = softcap > 0.0f ? softcap * tanhf(sc[i] * scale / softcap) * kLog2e
                                 : sc[i] * scale2;
        const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1), q = q_pos + 8 * ((i >> 1) & 1);
        if (EXTRA) x = fmaf(-slope2, fabsf(static_cast<float>(q - kp)), x);
        if (need_mask) {
          bool live = kp < kv_len;
          if (causal) live = live && kp <= q;
          if (window > 0) live = live && kp > q - window;
          x = live ? x : kMask;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    if (fold) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = fast_exp2(fmaf(sc[i], scale2, -m[(i >> 1) & 1]));
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = fast_exp2(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if (EXTRA && drop.on()) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1), q = q_pos + 8 * ((i >> 1) & 1);
        sc[i] = drop.keep(h0, q, kp) ? sc[i] * drop.scale : 0.0f;
      }
    }
  }

  // The same, with the MASKS instance's `extra` mask as well.
  template <class Extra>
  __device__ __forceinline__ void softmax(float (&sc)[BN / 2], int k0, float (&m)[2],
                                          float (&l)[2], float (&alpha)[2],
                                          const Extra& extra) const {
    const float scale2 = scale * kLog2e;
    const bool need_mask = k0 + BN > kv_len || (causal && k0 + BN - 1 > wg_min) ||
                           (window > 0 && k0 <= wg_min + 63 - window) ||
                           extra.cuts(k0, k0 + BN - 1);
    float mx[2] = {-INFINITY, -INFINITY};
    // Unmasked, uncapped, unbiased tiles (most of a long prompt) take the max
    // of the raw scores and fold the scale into the exponent's multiply-add.
    const bool fold = !need_mask && softcap <= 0.0f && scale2 > 0.0f && (!EXTRA || slope2 == 0.0f);
    if (fold) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] *= scale2;
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = softcap > 0.0f ? softcap * tanhf(sc[i] * scale / softcap) * kLog2e
                                 : sc[i] * scale2;
        const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1), q = q_pos + 8 * ((i >> 1) & 1);
        if (EXTRA) x = fmaf(-slope2, fabsf(static_cast<float>(q - kp)), x);
        if (need_mask) {
          bool live = kp < kv_len;
          if (causal) live = live && kp <= q;
          if (window > 0) live = live && kp > q - window;
          live = live && extra((i >> 1) & 1, kp);
          x = live ? x : kMask;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    if (fold) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = fast_exp2(fmaf(sc[i], scale2, -m[(i >> 1) & 1]));
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float p = fast_exp2(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        rs[(i >> 1) & 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    if (EXTRA && drop.on()) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int kp = k0 + 8 * (i / 4) + 2 * quad + (i & 1), q = q_pos + 8 * ((i >> 1) & 1);
        sc[i] = drop.keep(h0, q, kp) ? sc[i] * drop.scale : 0.0f;
      }
    }
  }
};

// MODE 0: the plain instance; 1 (EXTRA): ALiBi and dropout; 2 (MASKS):
// segment ids and the chunk, with ALiBi and dropout.
template <int D, int NC, int MODE>
__global__ void __launch_bounds__((NC + 1) * 128, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ q_offset,
                 const int* __restrict__ kv_lens, const float* __restrict__ alibi, int Sq,
                 int Sk, int Hq, int Hk, float scale, int causal, int window, float softcap,
                 dropout::Params drop, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, int chunk) {
  constexpr bool EXTRA = MODE >= 1, MASKS = MODE == 2;
  using T = Tile<D>;
  using L = FwdSmem<D, NC>;
  constexpr int BN = L::BN;
  constexpr int CH = T::CW / 2;  // accumulator floats of one column chunk
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  auto k_full = [&](int s) { return base + L::BAR + 8u * (1 + s); };
  auto v_full = [&](int s) { return base + L::BAR + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return base + L::BAR + 8u * (1 + 2 * kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * NC * 64;  // heavy (late) tiles first
  const int kvh = h / (Hq / Hk);
  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);

  // This batch row's segment ids and the chunk (MASKS only).
  const SegChunk segc{MASKS && q_seg != nullptr ? q_seg + static_cast<size_t>(b) * Sq : nullptr,
                      MASKS && kv_seg != nullptr ? kv_seg + static_cast<size_t>(b) * Sk : nullptr,
                      Sq, Sk, MASKS ? chunk : 0};

  // Key tiles that can hold a live (q, k) pair for some row of this block.
  const int q_min = q_off + q0, q_max = q_off + min(q0 + NC * 64, Sq) - 1;
  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_max + 1);
  int kt_begin = 0;
  if (window > 0 && q_min - window + 1 > 0) kt_begin = (q_min - window + 1) / BN;
  if constexpr (MASKS) {  // the keys of the rows' chunks
    int k_lo = 0;
    segc.key_range(q_min, q_max, &k_lo, &k_hi);
    kt_begin = max(kt_begin, k_lo / BN);
  }
  const int kt_end = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;
  const int ntiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), NC * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::QB);
      for (int c = 0; c < T::NCH; ++c)
        tma_load_4d(base + L::Q + c * NC * 64 * T::SWZ, &tq, q_full, c * T::CW, h, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty(s), ((j / kStages) - 1) & 1);
        const int k0 = (kt_begin + j) * BN;
        mbar_arrive_expect_tx(k_full(s), L::KB);
        for (int c = 0; c < T::NCH; ++c)
          tma_load_4d(base + L::K + s * L::KB + c * BN * T::SWZ, &tk, k_full(s), c * T::CW, kvh,
                      k0, b);
        mbar_arrive_expect_tx(v_full(s), L::KB);
        for (int c = 0; c < T::NCH; ++c)
          tma_load_4d(base + L::V + s * L::KB + c * BN * T::SWZ, &tv, v_full(s), c * T::CW, kvh,
                      k0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64·wg .. + 63 ----
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const int bh = b * Hq + h;
    const Rows<EXTRA, BN> rows{scale, softcap, causal, window, kv_len, q_off + row0,
                           q_off + q0 + 64 * wg, quad,
                           EXTRA && alibi != nullptr ? alibi[bh] * kLog2e : 0.0f, drop,
                           EXTRA ? drop.head(static_cast<uint32_t>(bh)) : 0u};
    const auto extra = rows_live<MASKS>(segc, row0, q_off + row0, q_off + q0 + 64 * wg);

    float o[T::NCH][CH];
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
#pragma unroll
      for (int i = 0; i < CH; ++i) o[c][i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2] = {1.0f, 1.0f};
    float sc[BN / 2];
    uint32_t pf[BN / 16][4];

    // S(j) = Q·K(j)ᵀ into sc (issued, not waited for).
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      mbar_wait(k_full(s), (j / kStages) & 1);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dq = T::kmajor(base + L::Q, NC * 64, 64 * wg, kk);
        const uint64_t dk = T::kmajor(base + L::K + s * L::KB, BN, 0, kk);
        if constexpr (BN == 128) wgmma_ss_n128(sc, dq, dk, kk > 0);
        else wgmma_ss_n64(sc, dq, dk, kk > 0);
      }
      wgmma_commit();
    };

    // P(j)·V(j) into o (issued, not waited for), from P(j) in pf.
    auto issue_pv = [&](int j) {
      const int s = j % kStages;
      mbar_wait(v_full(s), (j / kStages) & 1);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < T::NCH; ++c) {
          const uint64_t dv = T::mnmajor(base + L::V + s * L::KB, BN, c, kk);
          if constexpr (T::CW == 64) wgmma_rs_n64_bt(o[c], pf[kk], dv);
          else wgmma_rs_n32_bt(o[c], pf[kk], dv);
        }
      wgmma_commit();
    };
    // P(j) from the softmax's p into pf, and O rescaled by its alpha.
    auto take_p = [&]() {
      acc_to_a<BN>(sc, pf);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
#pragma unroll
        for (int i = 0; i < CH; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    };
    // Waits for P(j)·V(j) and gives tile j's stage back to the producer.
    auto retire = [&](int j) {
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) fence_regs(o[c]);
      fence_regs(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(j % kStages));
    };

    mbar_wait(q_full, 0);
    if (ntiles > 0) {
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (MASKS) rows.softmax(sc, kt_begin * BN, m, l, alpha, extra);
      else rows.softmax(sc, kt_begin * BN, m, l, alpha);
    }
    // Tile j: P(j)·V(j) runs on the tensor cores while the softmax of tile
    // j + 1 runs on the scores S(j + 1), issued just before it. The last tile
    // is peeled off the loop: with the S issue under a condition inside it,
    // ptxas serialized every wgmma of the kernel.
    for (int j = 0; j + 1 < ntiles; ++j) {
      take_p();
      issue_s(j + 1);
      issue_pv(j);
      wgmma_wait<1>();  // S(j + 1) is done; P(j)·V(j) may still run
      fence_regs(sc);
      if constexpr (MASKS) rows.softmax(sc, (kt_begin + j + 1) * BN, m, l, alpha, extra);
      else rows.softmax(sc, (kt_begin + j + 1) * BN, m, l, alpha);
      retire(j);
    }
    if (ntiles > 0) {
      take_p();
      issue_pv(ntiles - 1);
      retire(ntiles - 1);
    }

    // ---- epilogue: out = O / l (0 on dead rows), lse = m + log l ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const size_t q_stride = static_cast<size_t>(Hq) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const bool dead = (l[r] == 0.0f) || (m[r] <= kMask * 0.5f);
      const float inv = dead ? 0.0f : 1.0f / l[r];
      __nv_bfloat16* orow = out + (static_cast<size_t>(b) * Sq + row) * q_stride + h * D;
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
#pragma unroll
        for (int nb = 0; nb < T::CW / 8; ++nb) {
          const int col = c * T::CW + 8 * nb + 2 * quad;
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[c][4 * nb + 2 * r] * inv, o[c][4 * nb + 2 * r + 1] * inv);
        }
      if (quad == 0)
        lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] =
            dead ? -INFINITY : (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

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

// One launch's inputs past the tensor maps.
struct FwdArgs {
  void* out;
  void* lse;
  const void* q_offset;
  const void* kv_lens;
  const float* alibi;  // [B, Hq] or null
  int B, Sq, Sk, Hq, Hk;
  float scale;
  int causal, window;
  float softcap;
  dropout::Params drop;
  const int* q_seg;  // [B, Sq] segment ids or null
  const int* kv_seg;  // [B, Sk]
  int chunk;
};

template <int D, int NC, int MODE>
int launch_nc(const void* q, const void* k, const void* v, const FwdArgs& a, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  constexpr int BN = FwdSmem<D, NC>::BN;
  int e = encode_bshd<D>(&tq, q, a.B, a.Sq, a.Hq, NC * 64);
  if (e == 0) e = encode_bshd<D>(&tk, k, a.B, a.Sk, a.Hk, BN);
  if (e == 0) e = encode_bshd<D>(&tv, v, a.B, a.Sk, a.Hk, BN);
  if (e != 0) return e;
  constexpr int bytes = FwdSmem<D, NC>::BYTES;
  // The shared-memory limit is set once per kernel instance (a
  // function-local static), not on every launch.
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_fwd_kernel<D, NC, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid(a.Hq, a.B, (a.Sq + NC * 64 - 1) / (NC * 64));
  flash_fwd_kernel<D, NC, MODE><<<grid, (NC + 1) * 128, bytes, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse),
      static_cast<const int*>(a.q_offset), static_cast<const int*>(a.kv_lens), a.alibi, a.Sq,
      a.Sk, a.Hq, a.Hk, a.scale, a.causal, a.window, a.softcap, a.drop, a.q_seg, a.kv_seg,
      a.chunk);
  return static_cast<int>(cudaGetLastError());
}

// 128 query rows a block when that grid still covers 90% of the SMs, else 64.
// At D = 128 always 64: a consumer thread's S, P and O (64 + 32 + 64
// registers) exceed the 168 a thread of a 384-thread block can hold; at
// D = 256 (S, P and O: 32 + 16 + 128) likewise.
template <int D, int MODE>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a, cudaStream_t s) {
  const long long blocks128 = static_cast<long long>((a.Sq + 127) / 128) * a.Hq * a.B;
  if constexpr (D < 128)
    if (blocks128 * 10 >= 9LL * num_sms()) return launch_nc<D, 2, MODE>(q, k, v, a, s);
  return launch_nc<D, 1, MODE>(q, k, v, a, s);
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const FwdArgs& a, cudaStream_t s) {
  if (a.q_seg != nullptr || a.chunk > 0) return launch<D, 2>(q, k, v, a, s);
  if (a.alibi != nullptr || a.drop.threshold != 0u || a.drop.scale != 1.0f)
    return launch<D, 1>(q, k, v, a, s);
  return launch<D, 0>(q, k, v, a, s);
}

}  // namespace

// window <= 0, softcap <= 0 and chunk <= 0 mean "off"; alibi ([B, Hq]
// float32 slopes) may be null; q_seg and kv_seg (int32 [B, Sq] and [B, Sk]
// segment ids) are both null or both set; drop_threshold 0 and drop_scale 1
// mean no dropout (the threshold and the seed are uint32 bits). D is 32,
// 64, 128 or 256; q, k and v are contiguous and 16-byte aligned.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                void* lse, const void* q_offset, const void* kv_lens,
                                const void* alibi, const void* q_seg, const void* kv_seg, int B,
                                int Sq, int Sk, int Hq, int Hk, int D, float scale, int causal,
                                int window, float softcap, int chunk, int drop_threshold,
                                int drop_seed, float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{out, lse, q_offset, kv_lens, static_cast<const float*>(alibi), B, Sq, Sk, Hq,
                  Hk, scale, causal, window, softcap,
                  dropout::Params{static_cast<uint32_t>(drop_threshold),
                                  static_cast<uint32_t>(drop_seed), drop_scale},
                  static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), chunk};
  switch (D) {
    case 32: return launch_d<32>(q, k, v, a, s);
    case 64: return launch_d<64>(q, k, v, a, s);
    case 128: return launch_d<128>(q, k, v, a, s);
    case 256: return launch_d<256>(q, k, v, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
