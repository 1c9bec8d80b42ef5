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
// softcap, the logit scale, ALiBi, dropout, segment ids and
// attention_chunk. ALiBi's -slope·|q_pos - k_pos|
// is added to z (after softcap) before p is formed; being additive it leaves
// the dS chain as it is (the softcap factor reads the unbiased z). Dropout
// rebuilds K3's keep mask (dropout.cuh): dV takes the kept p times
// 1/(1 - rate), dP is masked and scaled alike, dS takes the undropped p.
// Both ride the kernels' EXTRA instances (MODE 1). Segment ids and the
// chunk are K3's masks (hopper.cuh's SegChunk) in the MASKS instances (MODE
// 2, which take ALiBi and dropout too): the dQ kernel reads its rows' q ids
// and chunk starts once (RowsLive) and each tile's kv ids per column, the
// dKV kernel its keys' ids once and each query tile's q ids per column;
// both skip the tiles outside every row's chunk.
//
// Bound on the H100: operations. The backward's function is 2.5x the
// forward's matrix work (five products per live pair to the forward's two;
// these kernels do seven, S and dP in both); at the training shape (B 8,
// S 512, Hq 32, D 64, causal) that is ~21.5 GFLOP per layer, ~22 µs at
// 989 TFLOP/s bf16.
//
// Design: two kernels with no atomics, so two runs give the same bits. Each
// block is one producer warpgroup and two consumer warpgroups of 64 rows;
// the producer loads through TMA (4-D tensor maps over [B, S, H, D], rows
// past S as zeros) into a 2-stage ring with full and empty mbarriers. All
// five products run on wgmma with bf16 operands as stored (no transpose);
// score-shaped tiles stay in the accumulator registers, p and ds are formed
// there element by element
// (exp(z - lse) as one ex2 of z·log2(e) - lse·log2(e); the mask test only
// on tiles that cut the diagonal, kv_len or the window), and P/dS reach
// their products as register A fragments (RS). No float32 tile and no P/dS
// tile goes through shared memory.
//   dQ:  launched first. One block per (128-query tile, q head, batch row),
//        its Q and dO loaded once, walking the 64-key tiles K3 walks (at
//        D = 256 a 64-query tile and one consumer: dQ alone is 64 x 256
//        float32, 128 registers a thread, beside S and dP's 32 each). Each
//        consumer thread first sums di = rowsum(o·dO) for its two rows
//        (a quarter row per lane, then the quad) and writes it for the dKV
//        kernel. S = Q·Kᵀ and dP = dO·Vᵀ are SS (K-major both); dQ += dS·K
//        is RS with K MN-major. Heavy (late) query tiles first.
//   dKV: one block per (128-key tile, kv head, batch row); its K and V are
//        loaded once. It walks the (group head, query tile) pairs that can
//        reach its keys (causal, kv_len and window skip dead tiles) in the
//        TPU kernel's order, g-major, and sums the GQA group in its float32
//        dK/dV accumulators. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS; dV += Pᵀ·dO
//        and dK += dSᵀ·Q are RS with dO and Q MN-major. The ring carries
//        Q, dO and the tile's lse and di, which the producer warp's lanes
//        load with plain loads. Query tiles are 64 rows. At D = 128, where
//        dK and dV take 64 registers each, a block is one consumer of 64
//        keys with 32-row query tiles (see DkvSmem). At D = 256 a 64-key
//        block's dK and dV (64 x 256 float32 each) would take 256 registers
//        a thread, so D is split across two blocks of the grid: each holds
//        dK and dV for 128 of the columns (the D = 128 picture) and
//        recomputes the whole Sᵀ and dPᵀ, which contract over all of D.
//        Low key tiles, which the most queries reach, are scheduled first.
#include <limits.h>
#include <math.h>

#include "dropout.cuh"
#include "fp8_ftz.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int kStages = 2;

constexpr float kLog2e = 1.4426950408889634f;

// A row's lse as the kernels use it: nl = -lse·log2(e), or -inf for a dead
// row (lse -inf), so that p = 2^(z·log2(e) + nl) is 0 there.
__device__ __forceinline__ float neg_lse2(float lse) {
  return isfinite(lse) ? -lse * kLog2e : -INFINITY;
}

struct Mask {
  float scale, softcap;
  int causal, window, kv_len;

  __device__ __forceinline__ bool live(int q_pos, int k_pos) const {
    bool ok = k_pos < kv_len;
    if (causal) ok = ok && k_pos <= q_pos;
    if (window > 0) ok = ok && k_pos > q_pos - window;
    return ok;
  }

  // Whether some pair of queries [q_lo, q_hi] and keys [k_lo, k_hi] is
  // masked (else every pair is live and the tile skips the test).
  __device__ __forceinline__ bool cuts(int q_lo, int q_hi, int k_lo, int k_hi) const {
    return k_hi >= kv_len || (causal && k_hi > q_lo) || (window > 0 && k_lo <= q_hi - window);
  }

  // p and ds of one (query, key) pair from the raw dot q·k, dO·v, the row's
  // nl (neg_lse2) and di: the TPU kernel's _recompute_p_and_ds, element by
  // element, with exp(z - lse) taken as 2^(z·log2(e) + nl).
  __device__ __forceinline__ void p_ds(float qk, float dp, float nl, float di, bool ok,
                                       float& p, float& ds) const {
    if (softcap > 0.0f) {
      const float z = softcap * tanhf(qk * scale / softcap);
      p = ok ? fast_exp2(fmaf(z, kLog2e, nl)) : 0.0f;
      const float t = z / softcap;
      ds = p * (dp - di) * (1.0f - t * t) * scale;
    } else {
      p = ok ? fast_exp2(fmaf(qk, scale * kLog2e, nl)) : 0.0f;
      ds = p * (dp - di) * scale;
    }
  }

  // The same with ALiBi and dropout: nlb = nl - slope·log2(e)·|q - k| (the
  // bias enters p's exponent only), and under dropout p (the dV operand)
  // becomes the kept p times drop.scale, dP the kept dP times drop.scale,
  // while ds takes the undropped p.
  __device__ __forceinline__ void p_ds_extra(float qk, float dp, float nlb, float di, bool ok,
                                             bool kept, float drop_scale, float& p,
                                             float& ds) const {
    float t2 = 1.0f, pe;
    if (softcap > 0.0f) {
      const float z = softcap * tanhf(qk * scale / softcap);
      pe = ok ? fast_exp2(fmaf(z, kLog2e, nlb)) : 0.0f;
      const float t = z / softcap;
      t2 = 1.0f - t * t;
    } else {
      pe = ok ? fast_exp2(fmaf(qk, scale * kLog2e, nlb)) : 0.0f;
    }
    const float dpm = kept ? dp * drop_scale : 0.0f;
    ds = pe * (dpm - di) * t2 * scale;
    p = kept ? pe * drop_scale : 0.0f;
  }
};

// acc[c] (column chunk ch0 + c of a [64 rows][D] accumulator, NCO of them)
// += A·B, A the 64 x R bf16 fragments `a` (R / 16 reduction steps), B an
// [R][D] tile at `tile` read MN-major.
template <int D, int R, int NCO = Tile<D>::NCH>
__device__ __forceinline__ void rs_acc(float (&acc)[NCO][Tile<D>::CW / 2],
                                       const uint32_t (&a)[R / 16][4], uint32_t tile,
                                       int ch0 = 0) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NCO; ++c) {
      const uint64_t db = T::mnmajor(tile, R, ch0 + c, kk);
      if constexpr (T::CW == 64) wgmma_rs_n64_bt(acc[c], a[kk], db);
      else wgmma_rs_n32_bt(acc[c], a[kk], db);
    }
}

// s[64 x N] = A·Bᵀ over D: A rows [a_row0, +64) of a tile of a_rows rows,
// B the N rows of a tile at b (both K-major).
template <int D, int N>
__device__ __forceinline__ void ss_abt(float (&s)[N / 2], uint32_t a, int a_rows, int a_row0,
                                       uint32_t b) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = T::kmajor(a, a_rows, a_row0, kk), db = T::kmajor(b, N, 0, kk);
    if constexpr (N == 64) wgmma_ss_n64(s, da, db, kk > 0);
    else wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// Writes rows row0 and row0 + 8 (< rows_valid) of a [64][NCO·CW] accumulator
// held as chunks to out (row r at out + r·stride), bf16.
template <int D, int NCO = Tile<D>::NCH>
__device__ __forceinline__ void store_rows(const float (&acc)[NCO][Tile<D>::CW / 2],
                                           __nv_bfloat16* out, size_t stride, int row0,
                                           int rows_valid, int quad) {
  using T = Tile<D>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows_valid) continue;
    __nv_bfloat16* o = out + static_cast<size_t>(row) * stride;
#pragma unroll
    for (int c = 0; c < NCO; ++c)
#pragma unroll
      for (int nb = 0; nb < T::CW / 8; ++nb)
        *reinterpret_cast<uint32_t*>(o + c * T::CW + 8 * nb + 2 * quad) =
            pack_bf16(acc[c][4 * nb + 2 * r], acc[c][4 * nb + 2 * r + 1]);
  }
}

template <int N, int M>
__device__ __forceinline__ void zero(float (&acc)[N][M]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int i = 0; i < M; ++i) acc[c][i] = 0.0f;
}

template <int N, int M>
__device__ __forceinline__ void fence_acc(float (&acc)[N][M]) {
#pragma unroll
  for (int c = 0; c < N; ++c) fence_regs(acc[c]);
}

// ---------------------------------------------------------------- dKV ----

// A dKV block holds NC·64 keys (one consumer warpgroup per 64) and walks
// query tiles of BQ rows. At D = 128 a consumer thread's dK and dV take 64
// registers each, so the block has one consumer (the thread may hold 255
// registers, against 168 in a 384-thread block) and 32-row query tiles. At
// D = 256 the grid splits D's columns over SPLIT = 2 blocks, each holding
// NCO = 2 of the four 64-column chunks of dK and dV (the D = 128 registers).
template <int D>
struct DkvSmem {
  static constexpr int NC = D >= 128 ? 1 : 2;
  static constexpr int BK = 64 * NC;
  static constexpr int BQ = D >= 128 ? 32 : 64;
  static constexpr int SPLIT = D == 256 ? 2 : 1;
  static constexpr int NCO = Tile<D>::NCH / SPLIT;
  static constexpr int KB = BK * D * 2;  // K or V [BK keys][D]
  static constexpr int QB = BQ * D * 2;  // Q or dO [BQ queries][D]
  static constexpr int K = 0;
  static constexpr int V = K + KB;
  static constexpr int RING = V + KB;                     // stage s: Q, dO
  static constexpr int ROW = RING + kStages * 2 * QB;     // stage s: lse[BQ], di[BQ]
  static constexpr int BAR = ROW + kStages * 2 * BQ * 4;  // kv_full, full[2], empty[2]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int MODE>
__global__ void __launch_bounds__((DkvSmem<D>::NC + 1) * 128, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     const float* __restrict__ alibi, int Sq, int Sk, int Hq, int Hk,
                     float scale, int causal, int window, float softcap, dropout::Params drop,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int chunk) {
  constexpr bool EXTRA = MODE >= 1, MASKS = MODE == 2;
  using T = Tile<D>;
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L::ROW);
  const uint32_t kv_full = base + L::BAR;
  auto full = [&](int s) { return base + L::BAR + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BAR + 8u * (1 + kStages + s); };
  auto q_tile = [&](int s) { return base + L::RING + s * 2 * L::QB; };
  auto do_tile = [&](int s) { return base + L::RING + s * 2 * L::QB + L::QB; };

  const int hk = blockIdx.x / L::SPLIT, b = blockIdx.y, k0 = blockIdx.z * BK;  // low tiles first
  const int ch0 = (blockIdx.x % L::SPLIT) * L::NCO;  // the column chunks this block holds
  const int groups = Hq / Hk;
  const int q_off = q_offset[b];
  const Mask mask{scale, softcap, causal, window, min(kv_lens[b], Sk)};

  // Query tiles that can hold a live (q, k) pair for some key of this block.
  const int nq = (Sq + BQ - 1) / BQ;
  int qt_begin = 0, qt_end = k0 < mask.kv_len ? nq : 0;
  if (causal) {
    const int n = k0 - q_off;  // first query index whose position reaches k0
    qt_begin = n > 0 ? n / BQ : 0;
  }
  if (window > 0) {
    const int n = k0 + window + BK - 2 - q_off;  // last query index a key here reaches
    qt_end = min(qt_end, n >= 0 ? n / BQ + 1 : 0);
  }
  // This batch row's segment ids and the chunk (MASKS only).
  const SegChunk segc{MASKS && q_seg != nullptr ? q_seg + static_cast<size_t>(b) * Sq : nullptr,
                      MASKS && kv_seg != nullptr ? kv_seg + static_cast<size_t>(b) * Sk : nullptr,
                      Sq, Sk, MASKS ? chunk : 0};
  if constexpr (MASKS) {  // the queries in the chunks of this block's keys
    int lo = INT_MIN, hi = INT_MAX;
    segc.key_range(k0, k0 + BK - 1, &lo, &hi);
    const int n0 = lo - q_off, n1 = hi - 1 - q_off;  // first and last query index
    qt_begin = max(qt_begin, n0 > 0 ? n0 / BQ : 0);
    qt_end = min(qt_end, n1 >= 0 ? n1 / BQ + 1 : 0);
  }
  const int per_head = max(qt_end - qt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(empty(s), 4 * L::NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: warp 0 loads; lane 0 issues the TMA ----
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::KB);
        for (int c = 0; c < T::NCH; ++c) {
          tma_load_4d(base + L::K + c * BK * T::SWZ, &tk, kv_full, c * T::CW, hk, k0, b);
          tma_load_4d(base + L::V + c * BK * T::SWZ, &tv, kv_full, c * T::CW, hk, k0, b);
        }
      }
      int i = 0;
      for (int h = hk * groups; h < (hk + 1) * groups; ++h) {
        const size_t row_base = (static_cast<size_t>(b) * Hq + h) * Sq;
        for (int q0 = qt_begin * BQ; q0 < qt_end * BQ; q0 += BQ, ++i) {
          const int s = i & 1;
          if (i >= kStages) mbar_wait(empty(s), ((i >> 1) - 1) & 1);
          float* ls = rows_s + s * 2 * BQ;
          for (int r = lane; r < BQ; r += 32) {
            const bool in = q0 + r < Sq;
            ls[r] = in ? neg_lse2(lse[row_base + q0 + r]) : -INFINITY;
            ls[BQ + r] = in ? di[row_base + q0 + r] : 0.0f;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(full(s), 2 * L::QB);
            for (int c = 0; c < T::NCH; ++c) {
              tma_load_4d(q_tile(s) + c * BQ * T::SWZ, &tq, full(s), c * T::CW, h, q0, b);
              tma_load_4d(do_tile(s) + c * BQ * T::SWZ, &tdo, full(s), c * T::CW, h, q0, b);
            }
          } else {
            mbar_arrive(full(s));
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys k0 + 64·wg .. + 63 ----
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int key0 = k0 + 64 * wg + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
    const int steps = groups * per_head;
    int kid[2] = {0, 0};  // the two keys' segment ids (MASKS)
    if (MASKS && segc.q_ids != nullptr) {
      kid[0] = segc.kv_id(key0);
      kid[1] = segc.kv_id(key0 + 8);
    }

    float dk_acc[L::NCO][T::CW / 2], dv_acc[L::NCO][T::CW / 2];
    zero(dk_acc);
    zero(dv_acc);
    mbar_wait(kv_full, 0);
    const int key_lo = k0 + 64 * wg;
    for (int i = 0; i < steps; ++i) {
      const int s = i & 1;
      const uint32_t ph = (i >> 1) & 1;
      const int q0 = (qt_begin + i % per_head) * BQ;
      float slope2 = 0.0f;  // this step's head's ALiBi slope · log2(e)
      uint32_t h0 = 0u;     // and its dropout hash half
      if constexpr (EXTRA) {
        const int bh = b * Hq + hk * groups + i / per_head;
        if (alibi != nullptr) slope2 = alibi[bh] * kLog2e;
        h0 = drop.head(static_cast<uint32_t>(bh));
      }
      const bool need_mask =
          mask.cuts(q_off + q0, q_off + q0 + BQ - 1, key_lo, key_lo + 63) ||
          (MASKS && segc.cuts(q_off + q0, q_off + q0 + BQ - 1, key_lo, key_lo + 63));
      // MASKS: the chunk start of this query tile where its rows share one
      // chunk (the usual case), so that a score's chunk test divides nothing.
      const int tile_cs = MASKS ? segc.shared_start(q_off + q0, q_off + q0 + BQ - 1) : 0;
      float st[BQ / 2], dpt[BQ / 2];

      mbar_wait(full(s), ph);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
      ss_abt<D, BQ>(st, base + L::K, BK, 64 * wg, q_tile(s));    // Sᵀ = K·Qᵀ
      ss_abt<D, BQ>(dpt, base + L::V, BK, 64 * wg, do_tile(s));  // dPᵀ = V·dOᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const float* ls = rows_s + s * 2 * BQ;
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e / 4) + 2 * quad + (e & 1);  // query within the tile
        const int kp = key0 + 8 * ((e >> 1) & 1);
        float p, ds;
        const bool ok = !need_mask || (mask.live(q_off + q0 + col, kp) &&
                                       (!MASKS || segc.live(q_off + q0 + col, tile_cs,
                                                            segc.q_ids ? segc.q_id(q0 + col) : 0,
                                                            kp, kid[(e >> 1) & 1])));
        if constexpr (EXTRA) {
          const int qp = q_off + q0 + col;
          mask.p_ds_extra(st[e], dpt[e],
                          fmaf(-slope2, fabsf(static_cast<float>(qp - kp)), ls[col]),
                          ls[BQ + col], ok, drop.keep(h0, qp, kp), drop.scale, p, ds);
        } else {
          mask.p_ds(st[e], dpt[e], ls[col], ls[BQ + col], ok, p, ds);
        }
        st[e] = p;
        dpt[e] = ds;
      }
      uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
      acc_to_a<BQ>(st, pf);
      acc_to_a<BQ>(dpt, dsf);

      fence_acc(dv_acc);
      fence_acc(dk_acc);
      wgmma_fence();
      rs_acc<D, BQ, L::NCO>(dv_acc, pf, do_tile(s), ch0);  // dV += Pᵀ·dO
      rs_acc<D, BQ, L::NCO>(dk_acc, dsf, q_tile(s), ch0);  // dK += dSᵀ·Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv_acc);
      fence_acc(dk_acc);
      fence_regs(pf);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    const size_t kv_stride = static_cast<size_t>(Hk) * D;
    const size_t kv_base = static_cast<size_t>(b) * Sk * kv_stride + static_cast<size_t>(hk) * D +
                           static_cast<size_t>(ch0) * T::CW;
    store_rows<D, L::NCO>(dk_acc, dk + kv_base, kv_stride, key0, Sk, quad);
    store_rows<D, L::NCO>(dv_acc, dv + kv_base, kv_stride, key0, Sk, quad);
  }
}

// ----------------------------------------------------------------- dQ ----

// A dQ block holds NC·64 queries (one consumer warpgroup per 64): 128, or 64
// at D = 256, where dQ alone takes 128 registers a thread.
template <int D>
struct DqSmem {
  static constexpr int NC = D == 256 ? 1 : 2;
  static constexpr int QR = 64 * NC;
  static constexpr int QB = QR * D * 2;  // Q or dO [QR queries][D]
  static constexpr int KB = 64 * D * 2;   // K or V [64 keys][D]
  static constexpr int Q = 0;
  static constexpr int DO = Q + QB;
  static constexpr int RING = DO + QB;  // stage s: K, V
  static constexpr int BAR = RING + kStages * 2 * KB;  // q_full, full[2], empty[2]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * kStages) + 1024;
};

// di = rowsum(o·dO) of rows row0 and row0 + 8 (0 past Sq), in float32: each
// lane of the quad sums a quarter of the row, then the quad adds.
template <int D>
__device__ __forceinline__ void row_di(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                                       size_t stride, int row0, int Sq, int quad,
                                       float (&di)[2]) {
  constexpr int Q4 = D / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.0f;
    if (row < Sq) {
      const uint4* a = reinterpret_cast<const uint4*>(o + row * stride + quad * Q4);
      const uint4* g = reinterpret_cast<const uint4*>(dout + row * stride + quad * Q4);
#pragma unroll
      for (int v = 0; v < Q4 / 8; ++v) {
        const uint4 x = a[v], y = g[v];
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
          const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[j]));
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    di[r] = acc;
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__((DqSmem<D>::NC + 1) * 128, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ di_out,
                    const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ dq, const float* __restrict__ alibi, int Sq,
                    int Sk, int Hq, int Hk, float scale, int causal, int window, float softcap,
                    dropout::Params drop, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, int chunk) {
  constexpr bool EXTRA = MODE >= 1, MASKS = MODE == 2;
  using T = Tile<D>;
  using L = DqSmem<D>;
  constexpr int QR = L::QR;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  auto full = [&](int s) { return base + L::BAR + 8u * (1 + s); };
  auto empty = [&](int s) { return base + L::BAR + 8u * (1 + kStages + s); };
  auto k_tile = [&](int s) { return base + L::RING + s * 2 * L::KB; };
  auto v_tile = [&](int s) { return base + L::RING + s * 2 * L::KB + L::KB; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QR;  // heavy (late) tiles first
  const int hk = h / (Hq / Hk);
  const int q_off = q_offset[b];
  const Mask mask{scale, softcap, causal, window, min(kv_lens[b], Sk)};

  // Key tiles that can hold a live (q, k) pair for some row (as K3's forward).
  const int q_min = q_off + q0, q_max = q_off + min(q0 + QR, Sq) - 1;
  const SegChunk segc{MASKS && q_seg != nullptr ? q_seg + static_cast<size_t>(b) * Sq : nullptr,
                      MASKS && kv_seg != nullptr ? kv_seg + static_cast<size_t>(b) * Sk : nullptr,
                      Sq, Sk, MASKS ? chunk : 0};
  int k_hi = mask.kv_len;
  if (causal) k_hi = min(k_hi, q_max + 1);
  int kt_begin = 0;
  if (window > 0 && q_min - window + 1 > 0) kt_begin = (q_min - window + 1) / 64;
  if constexpr (MASKS) {  // the keys of the rows' chunks
    int k_lo = 0;
    segc.key_range(q_min, q_max, &k_lo, &k_hi);
    kt_begin = max(kt_begin, k_lo / 64);
  }
  const int kt_end = k_hi > 0 ? (k_hi + 63) / 64 : 0;
  const int ntiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * L::NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::QB);
      for (int c = 0; c < T::NCH; ++c) {
        tma_load_4d(base + L::Q + c * QR * T::SWZ, &tq, q_full, c * T::CW, h, q0, b);
        tma_load_4d(base + L::DO + c * QR * T::SWZ, &tdo, q_full, c * T::CW, h, q0, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j & 1;
        if (j >= kStages) mbar_wait(empty(s), ((j >> 1) - 1) & 1);
        const int kt0 = (kt_begin + j) * 64;
        mbar_arrive_expect_tx(full(s), 2 * L::KB);
        for (int c = 0; c < T::NCH; ++c) {
          tma_load_4d(k_tile(s) + c * 64 * T::SWZ, &tk, full(s), c * T::CW, hk, kt0, b);
          tma_load_4d(v_tile(s) + c * 64 * T::SWZ, &tv, full(s), c * T::CW, hk, kt0, b);
        }
      }
    }
  } else {
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const size_t q_stride = static_cast<size_t>(Hq) * D;
    const size_t q_base = static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * D;
    const size_t row_base = (static_cast<size_t>(b) * Hq + h) * Sq;
    // di of this thread's rows, from o and dO; written for the dKV kernel.
    float di_r[2], nl_r[2];
    row_di<D>(o + q_base, dout + q_base, q_stride, row0, Sq, quad, di_r);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row0 + 8 * r < Sq;
      nl_r[r] = in ? neg_lse2(lse[row_base + row0 + 8 * r]) : -INFINITY;
      if (in && quad == 0) di_out[row_base + row0 + 8 * r] = di_r[r];
    }
    const int wg_min = q_off + q0 + 64 * wg;
    const auto extra = rows_live<MASKS>(segc, row0, q_off + row0, wg_min);
    float slope2 = 0.0f;  // ALiBi slope · log2(e)
    uint32_t h0 = 0u;     // the dropout hash half of (b, h)
    if constexpr (EXTRA) {
      if (alibi != nullptr) slope2 = alibi[b * Hq + h] * kLog2e;
      h0 = drop.head(static_cast<uint32_t>(b * Hq + h));
    }

    float dq_acc[T::NCH][T::CW / 2];
    zero(dq_acc);
    mbar_wait(q_full, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int s = j & 1;
      const uint32_t ph = (j >> 1) & 1;
      const int kt0 = (kt_begin + j) * 64;
      const bool need_mask = mask.cuts(wg_min, wg_min + 63, kt0, kt0 + 63) ||
                             extra.cuts(kt0, kt0 + 63);
      float sc[32], dp[32];

      mbar_wait(full(s), ph);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      ss_abt<D, 64>(sc, base + L::Q, QR, 64 * wg, k_tile(s));   // S = Q·Kᵀ
      ss_abt<D, 64>(dp, base + L::DO, QR, 64 * wg, v_tile(s));  // dP = dO·Vᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        const int kp = kt0 + 8 * (e / 4) + 2 * quad + (e & 1);
        float p, ds;
        const bool ok = !need_mask || (mask.live(q_off + row0 + 8 * r, kp) && extra(r, kp));
        if constexpr (EXTRA) {
          const int qp = q_off + row0 + 8 * r;
          mask.p_ds_extra(sc[e], dp[e], fmaf(-slope2, fabsf(static_cast<float>(qp - kp)), nl_r[r]),
                          di_r[r], ok, drop.keep(h0, qp, kp), drop.scale, p, ds);
        } else {
          mask.p_ds(sc[e], dp[e], nl_r[r], di_r[r], ok, p, ds);
        }
        dp[e] = ds;
      }
      uint32_t dsf[4][4];
      acc_to_a<64>(dp, dsf);

      fence_acc(dq_acc);
      wgmma_fence();
      rs_acc<D, 64>(dq_acc, dsf, k_tile(s));  // dQ += dS·K
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq_acc);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    store_rows<D>(dq_acc, dq + q_base, q_stride, row0, Sq, quad);
  }
}

// One launch's inputs past the tensors the tensor maps cover.
struct BwdArgs {
  const float* alibi;  // [B, Hq] or null
  int B, Sq, Sk, Hq, Hk;
  float scale;
  int causal, window;
  float softcap;
  dropout::Params drop;
  const int* q_seg;  // [B, Sq] segment ids or null
  const int* kv_seg;  // [B, Sk]
  int chunk;

  // The kernels' instance: 2 (MASKS), 1 (EXTRA) or 0.
  int mode() const {
    if (q_seg != nullptr || chunk > 0) return 2;
    return alibi != nullptr || drop.threshold != 0u || drop.scale != 1.0f ? 1 : 0;
  }
};

template <int D, int MODE>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, const void* q_offset, const void* kv_lens, void* dk, void* dv,
               const BwdArgs& a, cudaStream_t s) {
  CUtensorMap tq, tk, tv, tdo;
  using L = DkvSmem<D>;
  int e = encode_bshd<D>(&tq, q, a.B, a.Sq, a.Hq, L::BQ);
  if (e == 0) e = encode_bshd<D>(&tdo, dout, a.B, a.Sq, a.Hq, L::BQ);
  if (e == 0) e = encode_bshd<D>(&tk, k, a.B, a.Sk, a.Hk, L::BK);
  if (e == 0) e = encode_bshd<D>(&tv, v, a.B, a.Sk, a.Hk, L::BK);
  if (e != 0) return e;
  constexpr int bytes = L::BYTES;
  // Set once per kernel instance (a function-local static), not per launch.
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid(a.Hk * L::SPLIT, a.B, (a.Sk + L::BK - 1) / L::BK);
  flash_bwd_dkv_kernel<D, MODE><<<grid, (L::NC + 1) * 128, bytes, s>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.alibi, a.Sq, a.Sk,
      a.Hq, a.Hk, a.scale, a.causal, a.window, a.softcap, a.drop, a.q_seg, a.kv_seg, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* di, const void* q_offset, const void* kv_lens, void* dq,
              const BwdArgs& a, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0 || reinterpret_cast<uintptr_t>(dout) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tq, tk, tv, tdo;
  using L = DqSmem<D>;
  int e = encode_bshd<D>(&tq, q, a.B, a.Sq, a.Hq, L::QR);
  if (e == 0) e = encode_bshd<D>(&tdo, dout, a.B, a.Sq, a.Hq, L::QR);
  if (e == 0) e = encode_bshd<D>(&tk, k, a.B, a.Sk, a.Hk, 64);
  if (e == 0) e = encode_bshd<D>(&tv, v, a.B, a.Sk, a.Hk, 64);
  if (e != 0) return e;
  constexpr int bytes = L::BYTES;
  // Set once per kernel instance (a function-local static), not per launch.
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid(a.Hq, a.B, (a.Sq + L::QR - 1) / L::QR);
  flash_bwd_dq_kernel<D, MODE><<<grid, (L::NC + 1) * 128, bytes, s>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(di), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(dq), a.alibi, a.Sq, a.Sk,
      a.Hq, a.Hk, a.scale, a.causal, a.window, a.softcap, a.drop, a.q_seg, a.kv_seg, a.chunk);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs bwd_args(const void* alibi, const void* q_seg, const void* kv_seg, int B, int Sq,
                 int Sk, int Hq, int Hk, float scale, int causal, int window, float softcap,
                 int chunk, int drop_threshold, int drop_seed, float drop_scale) {
  return BwdArgs{static_cast<const float*>(alibi), B, Sq, Sk, Hq, Hk, scale, causal, window,
                 softcap,
                 dropout::Params{static_cast<uint32_t>(drop_threshold),
                                 static_cast<uint32_t>(drop_seed), drop_scale},
                 static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), chunk};
}

}  // namespace

// window <= 0, softcap <= 0 and chunk <= 0 mean "off"; alibi ([B, Hq]
// float32 slopes) may be null, q_seg and kv_seg (int32 [B, Sq], [B, Sk]) are
// both null or both set; drop_threshold 0 and drop_scale 1 mean no dropout
// (K3's arguments). D is 32, 64, 128 or 256; q, k, v, o and dout are contiguous
// and 16-byte aligned. The dQ kernel also writes di (float32 [B, Hq, Sq]), which
// the dKV kernel reads: launch dQ first.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di,
                                    const void* q_offset, const void* kv_lens, void* dk,
                                    void* dv, const void* alibi, const void* q_seg,
                                    const void* kv_seg, int B, int Sq, int Sk, int Hq, int Hk,
                                    int D, float scale, int causal, int window, float softcap,
                                    int chunk, int drop_threshold, int drop_seed,
                                    float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a = bwd_args(alibi, q_seg, kv_seg, B, Sq, Sk, Hq, Hk, scale, causal, window,
                             softcap, chunk, drop_threshold, drop_seed, drop_scale);
#define K6_DKV_MODE(DD, M) \
  launch_dkv<DD, M>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, a, s)
#define K6_DKV(DD)                                        \
  return a.mode() == 2   ? K6_DKV_MODE(DD, 2)              \
         : a.mode() == 1 ? K6_DKV_MODE(DD, 1)              \
                         : K6_DKV_MODE(DD, 0)
  switch (D) {
    case 32: K6_DKV(32);
    case 64: K6_DKV(64);
    case 128: K6_DKV(128);
    case 256: K6_DKV(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6_DKV
#undef K6_DKV_MODE
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* di,
                                   const void* q_offset, const void* kv_lens, void* dq,
                                   const void* alibi, const void* q_seg, const void* kv_seg,
                                   int B, int Sq, int Sk, int Hq, int Hk, int D, float scale,
                                   int causal, int window, float softcap, int chunk,
                                   int drop_threshold, int drop_seed, float drop_scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs a = bwd_args(alibi, q_seg, kv_seg, B, Sq, Sk, Hq, Hk, scale, causal, window,
                             softcap, chunk, drop_threshold, drop_seed, drop_scale);
#define K6_DQ_MODE(DD, M) launch_dq<DD, M>(q, k, v, o, dout, lse, di, q_offset, kv_lens, dq, a, s)
#define K6_DQ(DD)                                       \
  return a.mode() == 2   ? K6_DQ_MODE(DD, 2)             \
         : a.mode() == 1 ? K6_DQ_MODE(DD, 1)             \
                         : K6_DQ_MODE(DD, 0)
  switch (D) {
    case 32: K6_DQ(32);
    case 64: K6_DQ(64);
    case 128: K6_DQ(128);
    case 256: K6_DQ(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K6_DQ
#undef K6_DQ_MODE
}
