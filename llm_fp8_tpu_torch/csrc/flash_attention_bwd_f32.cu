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
// Design: two kernels (and a sum pass) with no atomics, so two runs give
// the same bits. Products on wgmma m64nNk8 .tf32 (tf32x3.cuh), A from
// registers, B from shared memory; TF32 wgmma takes its shared-memory
// operand K-major only, so the split stage writes transposed copies where a
// product reduces over a tile's rows. Each block is one or two warpgroups of
// 64 rows (Rows: two share each streamed tile's copy and split; one where
// shared memory or registers leave room for one). Both kernels copy the
// rows they walk with cp.async, tile j + 1's in flight while tile j's
// products run; the split stage then writes each B operand of the tile once
// into TF32 planes (big and small parts), which the wgmmas read and convert
// nothing. Each warp splits its own rows' A fragments (Q and dO in dQ, K and
// V in dKV) from the float32 rows the block keeps, a k-step at a time, the
// next step's loads and split running while the last step's wgmmas do.
//   dQ:  launched first. One block per (64·NWG query rows, q head, batch
//        row); Q and dO are copied once (unpadded, swizzled rows at D 128,
//        which leaves room for 32-key tiles), and each thread first sums
//        di = rowsum(o·dO) for its two rows (a quarter of the row per lane,
//        then the quad) and writes it for the dKV kernel. The block walks
//        the key tiles K3 walks (BN keys, Cfg); each tile's K goes into a
//        row-order plane (S = Q·Kᵀ's B), V into another (dP = dO·Vᵀ's B),
//        and K transposed into a third (dQ += ds·K's B) or, at D >= 128,
//        over V's once dP is done. S and dP stay in the accumulator
//        registers, ds is formed there and feeds dQ += ds·K as the A
//        fragment in place (tf32x3::c_as_a). dQ stays in registers.
//   dKV: one block per (64·NWG keys, kv head, slice of the GQA group, batch
//        row); K and V are copied once. The block walks its slice's q heads
//        and, for each, the query tiles that can reach its keys (BQ
//        queries), copying Q, dO and the tile's lse and di. Sᵀ = K·Qᵀ and
//        dPᵀ = V·dOᵀ (keys as rows) read Q's and dO's row-order planes; pᵀ
//        and dsᵀ are formed in the registers and feed dV += pᵀ·dO and dK +=
//        dsᵀ·Q as A fragments in place, reading dO's and Q's transposed
//        planes. At D 256, where dK and dV would take D registers a thread
//        together, a block computes one of them (grid x doubled: odd blocks
//        dK, even blocks dV), and dK's Q transposed is written over dO's
//        plane once dPᵀ is done. The wrapper's plan
//        (kernels/flash_attention_bwd.py::dkv_slices) splits the group into
//        slices when kv heads, key tiles and batch rows alone give too few
//        blocks for the card (SantaCoder's MQA: 16 q heads over 1): each
//        slice writes its partial dK and dV to float32 scratch the wrapper
//        allocates, and the sum pass adds the partials in slice order.
// dQ, dK and dV are sums over thousands of products: each tile's share is
// summed in the tensor cores from zero and added to the running float32 sum
// with a rounding add (tile_product: the tensor cores' accumulation drops
// low bits, and a sum carried through them drifts). A warpgroup whose rows
// lie wholly outside a causal tile skips its products (it still copies and
// splits). p is 2^x by the special-function unit (ex2.approx: about 2 ulp,
// results below 2^-126 flushed to 0).
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "dropout.cuh"
#include "fp8_ftz.cuh"
#include "tf32x3.cuh"

namespace {

using tf32x3::c_as_a;
using tf32x3::cp_rows;
using tf32x3::load4;
using tf32x3::split_plane;
using tf32x3::split_plane_t;

constexpr float kLog2e = 1.4426950408889634f;

// Tile sizes: the largest that keep a block's shared memory at two blocks
// an SM up to D 80 (one at D 128 and 256, where 227 KB is nearly full).
enum Kernel { kDQ, kDKV };

// The rows of a block (queries in dQ, keys in dKV): NWG warpgroups of 64.
// Two share each streamed tile's copy and split; one where two warpgroups'
// rows of Q and dO (K and V) would fill shared memory (D 256), or where
// their registers would keep a second block off the SM (dKV at D <= 64).
template <int D, int KERNEL>
struct Rows {
  static constexpr int NWG = D == 256 || (KERNEL == kDKV && D <= 64) ? 1 : 2;
  static constexpr int BM = 64 * NWG;   // rows a block
  static constexpr int NT = 128 * NWG;  // threads a block
};

// The two kernels' block sizes, as __launch_bounds__ takes them.
template <int D>
constexpr int kDQThreads = Rows<D, kDQ>::NT;
template <int D>
constexpr int kDKVThreads = Rows<D, kDKV>::NT;

template <int D>
struct Cfg {
  static constexpr int LD = D + 4;  // floats between the rows of the float32 tiles
  static constexpr int BN = D == 32 ? 64 : D == 64 || D == 128 ? 32 : 16;  // dQ: keys a tile
  static constexpr int BQ = D == 32 ? 64 : 16;                 // dKV: queries a tile
  // Output columns a wgmma chain of dQ += ds·K, and of dK, dV (whose two
  // sums already hold D registers a thread).
  static constexpr int NC_DQ = D <= 80 ? D : D == 128 ? 64 : 32;
  static constexpr int NC_DKV = D <= 80 ? D : 32;
  static constexpr bool SPLIT = D == 256;      // dKV: dK and dV in separate blocks
  // Room for a third plane beside the tile's others (dQ's K transposed,
  // dK's Q transposed); where there is none (dQ at D >= 128, dK at D 256) the
  // transposed plane is written late, over a plane the first products are
  // done with.
  static constexpr bool DQ_T_PLANE = D <= 80;
  static constexpr bool T_PLANE = D != 256;
  // dQ's Q and dO rows: unpadded (swizzled) at D 128, which leaves room for
  // 32-key tiles beside two warpgroups' rows.
  using DQRows = tf32x3::F32Tile<D, D == 128>;
  // dQ: Q and dO, the raw K and V tiles in flight, K's and V's planes, K's
  // transposed plane.
  static constexpr int DQ_BYTES =
      4 * (2 * Rows<D, kDQ>::BM * DQRows::LD + 2 * BN * LD + (DQ_T_PLANE ? 3 : 2) * 2 * BN * D);
  // dKV: K and V, the raw Q and dO tiles, lse and di in flight, the tile's
  // -lse·log2(e) and di, and the planes (Q, dO, Q transposed, dO transposed;
  // a dK block takes the first three, a dV block Q and dO transposed).
  static constexpr int DKV_PLANES = SPLIT ? (T_PLANE ? 3 : 2) : 4;
  static constexpr int DKV_BYTES =
      4 * (2 * Rows<D, kDKV>::BM * LD + 2 * BQ * LD + 4 * BQ + DKV_PLANES * 2 * BQ * D);
  static_assert(DQ_BYTES <= 232448 && DKV_BYTES <= 232448, "K6 f32: shared memory");
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
  return hopper::fast_exp2(x);
}

// acc += a·B over one tile: a the tile's accumulator (this warpgroup's rows,
// K = 8·NK positions in the c_as_a order), B the plane `pl` (D rows, the
// output's columns; K columns). The tensor cores' float32 accumulation does
// not round to nearest (it drops the low bits), so a sum carried through
// thousands of products drifts toward zero: ~2^-12 of dK and dV after
// Falcon-7B's 71 q heads x 300 queries on an H100. Each tile's product
// therefore starts from zero (a wgmma chain of NC columns at a time) and is
// added to the running sum with a rounding float32 add.
template <int PASSES, int D, int K, int NC>
__device__ __forceinline__ void tile_product(float (&acc)[D / 2], const float* a,
                                             const uint32_t* pl) {
  uint32_t ab[K / 8][4], as[K / 8][4];
#pragma unroll
  for (int n = 0; n < K / 8; ++n) c_as_a<PASSES>(a + 4 * n, ab[n], as[n]);
#pragma unroll
  for (int ch = 0; ch < D / NC; ++ch) {
    float part[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) part[i] = 0.0f;
    tf32x3::acc_product<PASSES, NC, K, D>(part, ab, as, pl, ch * NC, 0);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[ch * NC / 2 + i] += part[i];
  }
}

template <int D, int PASSES>
__global__ void __launch_bounds__(kDQThreads<D>)
flash_bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ di_out, const int* __restrict__ q_offset,
                        const int* __restrict__ kv_lens, float* __restrict__ dq,
                        const float* __restrict__ alibi, int Sq, int Sk, int Hq, int Hk,
                        float scale, int causal, dropout::Params drop) {
  constexpr int BM = Rows<D, kDQ>::BM, NT = Rows<D, kDQ>::NT, BN = Cfg<D>::BN;
  constexpr int LD = Cfg<D>::LD, V4 = D / 4, NG = BN / 8, DT = D / 8;
  constexpr int PL = 2 * BN * D;  // words of a plane (both parts)
  constexpr bool TP = Cfg<D>::DQ_T_PLANE;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  using QRows = typename Cfg<D>::DQRows;
  float* dos = qs + BM * QRows::LD;
  float* kraw = dos + BM * QRows::LD;
  float* vraw = kraw + BN * LD;
  uint32_t* kpl = reinterpret_cast<uint32_t*>(vraw + BN * LD);  // K, keys as rows
  uint32_t* vpl = kpl + PL;                                      // V, keys as rows
  uint32_t* ktpl = TP ? vpl + PL : vpl;  // K transposed (over V's plane at D >= 128)

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy (late) tiles first
  const int kvh = h / (Hq / Hk);
  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_rs = static_cast<size_t>(Hq) * D, k_rs = static_cast<size_t>(Hk) * D;
  const size_t bh = static_cast<size_t>(b) * Hq + h, kbase = static_cast<size_t>(b) * Sk;

  int k_hi = kv_len;
  if (causal) k_hi = min(k_hi, q_off + min(q0 + BM, Sq));
  const int ntiles = k_hi > 0 ? (k_hi + BN - 1) / BN : 0;

  cp_rows<D, BM, NT, QRows>(qs, q, q0, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
  cp_rows<D, BM, NT, QRows>(dos, dout, q0, Sq, static_cast<size_t>(b) * Sq, q_rs, h * D);
  if (ntiles > 0) {
    cp_rows<D, BN, NT>(kraw, k, 0, Sk, kbase, k_rs, kvh * D);
    cp_rows<D, BN, NT>(vraw, v, 0, Sk, kbase, k_rs, kvh * D);
  }
  tf32x3::cp_async_commit();
  tf32x3::cp_async_wait_all();
  __syncthreads();

  // di = rowsum(o·dO) for this thread's rows (local 64·wg + 16·warp + g and
  // + 8): lane t of the quad sums the float4 chunks t, t + 4, ... of the row.
  const int lr0 = 64 * wg + 16 * warp + g;
  // The last query position of this thread's warpgroup (its products skip
  // the key tiles past it) and whether the warpgroup has rows at all.
  const int wg_max = q_off + q0 + 64 * wg + 63;
  const bool wg_rows = q0 + 64 * wg < Sq;
  float di[2], nl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr0 + 8 * r;
    float sum = 0.0f;
    if (row < Sq) {
      const float* orow = o + (static_cast<size_t>(b) * Sq + row) * q_rs + h * D;
      for (int c4 = t; c4 < V4; c4 += 4) {
        const float4 a = load4(orow + 4 * c4);
        const float4 d = load4(dos + QRows::at(lr0 + 8 * r, 4 * c4));
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
  const float scale2 = scale * kLog2e;
  const float slope2 = alibi != nullptr ? alibi[bh] * kLog2e : 0.0f;
  const bool dropping = drop.on();
  const uint32_t h0 = drop.head(static_cast<uint32_t>(bh));

  float acc[D / 2];  // 8-column group c: acc[4c .. 4c + 3]
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BN;
    tf32x3::cp_async_wait_all();
    __syncthreads();  // tile j landed; the previous tile's products are done
    split_plane<PASSES, BN, D, NT>(kpl, kraw);
    split_plane<PASSES, BN, D, NT>(vpl, vraw);
    if constexpr (TP) split_plane_t<PASSES, BN, D, NT>(ktpl, kraw);
    hopper::fence_proxy_async();  // the planes, written by threads, are read by wgmma
    __syncthreads();
    auto fetch_next = [&]() {
      if (j + 1 < ntiles) {
        cp_rows<D, BN, NT>(kraw, k, k0 + BN, Sk, kbase, k_rs, kvh * D);
        cp_rows<D, BN, NT>(vraw, v, k0 + BN, Sk, kbase, k_rs, kvh * D);
      }
      tf32x3::cp_async_commit();
    };
    if constexpr (TP) fetch_next();
    // A warpgroup whose rows all precede the tile (or lie past Sq) skips its
    // products (where K's transposed plane is written late, it still writes
    // it below).
    const bool skip = (causal && k0 > wg_max) || !wg_rows;
    if (TP && skip) continue;

    // ---- S = Q·Kᵀ and dP = dO·Vᵀ (8-key group n: [4n .. 4n + 3]) ----
    float sdp[2][BN / 2];
    float (&s)[BN / 2] = sdp[0];
    float (&dp)[BN / 2] = sdp[1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.0f;
    if (!skip)
      tf32x3::rows_products<PASSES, BN, D, 2, QRows>(sdp, {qs, dos}, lr0, t, {kpl, vpl});

    // ---- ds = p·(dP - di)·scale, in place of S ----
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kp = k0 + 8 * n + 2 * t + (e & 1), qp = pos0 + 8 * r;
        const float p = prob(s[4 * n + e], scale2, nl[r], slope2, qp, kp, kv_len, causal);
        float d = dp[4 * n + e];
        if (dropping) d = drop.keep(h0, qp, kp) ? d * drop.scale : 0.0f;
        s[4 * n + e] = p * (d - di[r]) * scale;
      }

    if constexpr (!TP) {  // K transposed over V's plane, now read; then the next tile
      __syncthreads();
      split_plane_t<PASSES, BN, D, NT>(ktpl, kraw);
      hopper::fence_proxy_async();
      __syncthreads();
      fetch_next();
    }
    // ---- dQ += ds·K, ds from the score registers (keys 2t, 2t + 1) ----
    if (!skip) tile_product<PASSES, D, BN, Cfg<D>::NC_DQ>(acc, s, ktpl);
  }
  tf32x3::cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + lr0 + 8 * r;
    if (row >= Sq) continue;
    float* drow = dq + (static_cast<size_t>(b) * Sq + row) * q_rs + h * D;
#pragma unroll
    for (int c = 0; c < DT; ++c)
      *reinterpret_cast<float2*>(drow + 8 * c + 2 * t) =
          make_float2(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
  }
}

// The dKV block's walk: dK (DO_DK) and/or dV (DO_DV) of BM keys from key
// k0 of kv head kvh, batch row b, over the q heads h_lo..h_hi - 1 of the
// group (the block's slice) and the query tiles that reach the keys; the
// sums go to dk and dv (the slice's partials when the group is split).
template <int D, int PASSES, bool DO_DK, bool DO_DV>
__device__ __forceinline__ void dkv_block(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di_in, const int* __restrict__ q_offset,
    const int* __restrict__ kv_lens, float* __restrict__ dk, float* __restrict__ dv,
    const float* __restrict__ alibi, int k0, int kvh, int h_lo, int h_hi, int b, int Sq,
    int Sk, int Hq, int Hk, float scale, int causal, const dropout::Params& drop) {
  constexpr int BM = Rows<D, kDKV>::BM, NT = Rows<D, kDKV>::NT, BQ = Cfg<D>::BQ;
  constexpr int LD = Cfg<D>::LD, NQ = BQ / 8, DT = D / 8;
  constexpr int PL = 2 * BQ * D;  // words of a plane (both parts)
  // dK reads Q transposed from a plane of its own, or (at D 256) written
  // late over dO's, which Vᵀ·dO is done with.
  constexpr bool QT = DO_DK && Cfg<D>::T_PLANE;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BM * LD;
  float* qraw = vs + BM * LD;
  float* doraw = qraw + BQ * LD;
  float* lraw = doraw + BQ * LD;  // the next tile's lse
  float* draw = lraw + BQ;        // and di
  float* nls = draw + BQ;         // this tile's -lse·log2(e)
  float* dis = nls + BQ;          // and di
  uint32_t* qpl = reinterpret_cast<uint32_t*>(dis + BQ);  // Q, queries as rows
  uint32_t* dopl = qpl + PL;                              // dO, queries as rows (dK)
  uint32_t* qtpl = QT ? dopl + PL : dopl;                 // Q transposed (dK)
  uint32_t* dotpl = DO_DK ? qtpl + PL : qpl + PL;         // dO transposed (dV)

  const int q_off = q_offset[b];
  const int kv_len = min(kv_lens[b], Sk);
  const int group = Hq / Hk;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_rs = static_cast<size_t>(Hq) * D, k_rs = static_cast<size_t>(Hk) * D;
  const size_t qbase = static_cast<size_t>(b) * Sq, kbase = static_cast<size_t>(b) * Sk;
  const int lr0 = 64 * wg + 16 * warp + g;
  const int kp0 = k0 + lr0;        // this thread's keys: kp0, kp0 + 8
  const int wg_k0 = k0 + 64 * wg;  // its warpgroup's first key
  const float scale2 = scale * kLog2e;
  const bool dropping = drop.on();

  // Query tiles that can reach a live key of the block, for each head.
  const int qt0 = causal ? max(0, k0 - q_off) / BQ : 0;
  const int qt1 = k0 < kv_len ? (Sq + BQ - 1) / BQ : 0;
  const int nqt = max(0, qt1 - qt0), total = nqt * (h_hi - h_lo);

  // Tile `it` (head h_lo + it / nqt, query tile qt0 + it % nqt): its Q and dO
  // rows, lse and di into the raw stage.
  auto fetch = [&](int it) {
    if (it < total) {
      const int h = kvh * group + h_lo + it / nqt, q0 = (qt0 + it % nqt) * BQ;
      const size_t bh = static_cast<size_t>(b) * Hq + h;
      cp_rows<D, BQ, NT>(qraw, q, q0, Sq, qbase, q_rs, h * D);
      cp_rows<D, BQ, NT>(doraw, dout, q0, Sq, qbase, q_rs, h * D);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const bool in = q0 + i < Sq;
        tf32x3::cp_async4(lraw + i, in ? lse + bh * Sq + q0 + i : lse, in);
        tf32x3::cp_async4(draw + i, in ? di_in + bh * Sq + q0 + i : di_in, in);
      }
    }
    tf32x3::cp_async_commit();
  };

  cp_rows<D, BM, NT>(ks, k, k0, Sk, kbase, k_rs, kvh * D);
  if (DO_DK) cp_rows<D, BM, NT>(vs, v, k0, Sk, kbase, k_rs, kvh * D);
  fetch(0);

  // The dK and dV accumulators (the one a block does not compute is dead
  // code the compiler drops).
  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.0f;

  for (int it = 0; it < total; ++it) {
    const int h = kvh * group + h_lo + it / nqt, q0 = (qt0 + it % nqt) * BQ;
    const size_t bh = static_cast<size_t>(b) * Hq + h;
    tf32x3::cp_async_wait_all();
    __syncthreads();  // tile `it` landed; the previous tile's products are done
    split_plane<PASSES, BQ, D, NT>(qpl, qraw);
    if (DO_DK) split_plane<PASSES, BQ, D, NT>(dopl, doraw);
    if (QT) split_plane_t<PASSES, BQ, D, NT>(qtpl, qraw);
    if (DO_DV) split_plane_t<PASSES, BQ, D, NT>(dotpl, doraw);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      nls[i] = q0 + i < Sq ? neg_lse2(lraw[i]) : -INFINITY;
      dis[i] = draw[i];
    }
    hopper::fence_proxy_async();  // the planes, written by threads, are read by wgmma
    __syncthreads();  // the planes, lse and di are written and the raw stage free
    if (QT || !DO_DK) fetch(it + 1);
    // A warpgroup whose keys all follow every query of the tile, or lie past
    // kv_len, skips its products (at D 256, where the block is one
    // warpgroup, it still writes Q's transposed plane below).
    const bool skip = (causal && wg_k0 > q_off + q0 + BQ - 1) || wg_k0 >= kv_len;
    if ((QT || !DO_DK) && skip) continue;
    const float slope2 = alibi != nullptr ? alibi[bh] * kLog2e : 0.0f;
    const uint32_t h0 = drop.head(static_cast<uint32_t>(bh));

    // ---- Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys as rows; 8-query group n: [4n .. 4n + 3]) ----
    float sdp[2][BQ / 2];  // Sᵀ, and dPᵀ for dK
    float (&st)[BQ / 2] = sdp[0];
    float (&dpt)[BQ / 2] = sdp[1];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;
    if constexpr (DO_DK) {
      if (!skip)
        tf32x3::rows_products<PASSES, BQ, D, 2>(sdp, {ks, vs}, lr0, t, {qpl, dopl});
    } else {
      tf32x3::rows_products<PASSES, BQ, D, 1>(*reinterpret_cast<float(*)[1][BQ / 2]>(sdp),
                                              {ks}, lr0, t, {qpl});
    }

    // ---- pᵀ (dropped and scaled for dV) in place of Sᵀ, dsᵀ in place of dPᵀ ----
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * n + 2 * t + (e & 1), kp = kp0 + 8 * (e >> 1);
        const int qp = q_off + q0 + qi;
        const float p = prob(st[4 * n + e], scale2, nls[qi], slope2, qp, kp, kv_len, causal);
        const bool keep = !dropping || drop.keep(h0, qp, kp);
        if (DO_DK) {
          const float d = keep ? dpt[4 * n + e] * drop.scale : 0.0f;
          dpt[4 * n + e] = p * (d - dis[qi]) * scale;
        }
        st[4 * n + e] = keep ? p * drop.scale : 0.0f;
      }

    // ---- dV += pᵀ·dO and dK += dsᵀ·Q (queries 2t, 2t + 1 of each group) ----
    if constexpr (DO_DV) tile_product<PASSES, D, BQ, Cfg<D>::NC_DKV>(gv, st, dotpl);
    if constexpr (DO_DK) {
      if constexpr (!QT) {  // Q transposed over dO's plane, now read; then the next tile
        __syncthreads();
        split_plane_t<PASSES, BQ, D, NT>(qtpl, qraw);
        hopper::fence_proxy_async();
        __syncthreads();
        fetch(it + 1);
      }
      if (!skip) tile_product<PASSES, D, BQ, Cfg<D>::NC_DKV>(gk, dpt, qtpl);
    }
  }
  tf32x3::cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kp0 + 8 * r;
    if (key >= Sk) continue;
    const size_t off = (kbase + key) * k_rs + kvh * D;
    if (DO_DK) {
#pragma unroll
      for (int c = 0; c < DT; ++c)
        *reinterpret_cast<float2*>(dk + off + 8 * c + 2 * t) =
            make_float2(gk[4 * c + 2 * r], gk[4 * c + 2 * r + 1]);
    }
    if (DO_DV) {
#pragma unroll
      for (int c = 0; c < DT; ++c)
        *reinterpret_cast<float2*>(dv + off + 8 * c + 2 * t) =
            make_float2(gv[4 * c + 2 * r], gv[4 * c + 2 * r + 1]);
    }
  }
}

// Grid: (key tiles, doubled at D >= 128; kv heads x slices; batch rows).
// Slice s of nslices takes q heads s·group / nslices .. (s + 1)·group /
// nslices - 1 of each kv head's group and writes its sums at dk, dv plus
// s·part (part = 0 when the group is not split).
template <int D, int PASSES>
__global__ void __launch_bounds__(kDKVThreads<D>)
flash_bwd_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         const int* __restrict__ q_offset, const int* __restrict__ kv_lens,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const float* __restrict__ alibi, int Sq, int Sk, int Hq, int Hk,
                         int nslices, size_t part, float scale, int causal,
                         dropout::Params drop) {
  // Low key tiles, which the most queries reach, first.
  const int kvh = blockIdx.y % Hk, slice = blockIdx.y / Hk, b = blockIdx.z;
  const int group = Hq / Hk;
  const int h_lo = slice * group / nslices, h_hi = (slice + 1) * group / nslices;
  dk += slice * part;
  dv += slice * part;
  if (Cfg<D>::SPLIT) {
    const int k0 = (blockIdx.x >> 1) * Rows<D, kDKV>::BM;
    if (blockIdx.x & 1)
      dkv_block<D, PASSES, true, false>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv,
                                        alibi, k0, kvh, h_lo, h_hi, b, Sq, Sk, Hq, Hk, scale,
                                        causal, drop);
    else
      dkv_block<D, PASSES, false, true>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv,
                                        alibi, k0, kvh, h_lo, h_hi, b, Sq, Sk, Hq, Hk, scale,
                                        causal, drop);
  } else {
    dkv_block<D, PASSES, true, true>(q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, alibi,
                                     blockIdx.x * Rows<D, kDKV>::BM, kvh, h_lo, h_hi, b, Sq, Sk, Hq,
                                     Hk, scale, causal, drop);
  }
}

// dk = Σ_s parts[0][s], dv = Σ_s parts[1][s] (blockIdx.y picks the pair),
// in slice order: parts [2][nslices][n4] float4s.
__global__ void __launch_bounds__(256)
dkv_sum_kernel(const float4* __restrict__ parts, float4* __restrict__ dk,
               float4* __restrict__ dv, int n4, int nslices) {
  const float4* src = parts + static_cast<size_t>(blockIdx.y) * nslices * n4;
  float4* out = blockIdx.y ? dv : dk;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 a = src[i];
    for (int s = 1; s < nslices; ++s) {
      const float4 x = src[static_cast<size_t>(s) * n4 + i];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    out[i] = a;
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
  dim3 grid((a.Sq + Rows<D, kDQ>::BM - 1) / Rows<D, kDQ>::BM, a.Hq, a.B);
  flash_bwd_f32_dq_kernel<D, PASSES><<<grid, Rows<D, kDQ>::NT, bytes, s>>>(
      q, k, v, o, dout, lse, di, q_offset, kv_lens, dq, a.alibi, a.Sq, a.Sk, a.Hq, a.Hk,
      a.scale, a.causal, a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int PASSES>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* di, const int* q_offset, const int* kv_lens,
               float* dk, float* dv, int nslices, const Args& a, cudaStream_t s) {
  constexpr int bytes = Cfg<D>::DKV_BYTES;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_bwd_f32_dkv_kernel<D, PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  const int tiles = (a.Sk + Rows<D, kDKV>::BM - 1) / Rows<D, kDKV>::BM;
  dim3 grid(Cfg<D>::SPLIT ? 2 * tiles : tiles, a.Hk * nslices, a.B);
  const size_t part =
      nslices > 1 ? static_cast<size_t>(a.B) * a.Sk * a.Hk * D : static_cast<size_t>(0);
  flash_bwd_f32_dkv_kernel<D, PASSES><<<grid, Rows<D, kDKV>::NT, bytes, s>>>(
      q, k, v, dout, lse, di, q_offset, kv_lens, dk, dv, a.alibi, a.Sq, a.Sk, a.Hq, a.Hk,
      nslices, part, a.scale, a.causal, a.drop);
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

// The dKV kernel over nslices slices of each GQA group (the wrapper's
// plan): dk and dv are [nslices, B, Sk, Hk, D] (for one slice, the
// gradients themselves), slice s's partial sums at s·B·Sk·Hk·D. Several
// slices need flash_bwd_f32_dkv_sum_launch after.
extern "C" int flash_bwd_f32_dkv_launch(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* di,
                                        const void* q_offset, const void* kv_lens, void* dk,
                                        void* dv, const void* alibi, int B, int Sq, int Sk,
                                        int Hq, int Hk, int D, int nslices, float scale,
                                        int causal, int passes, int drop_threshold,
                                        int drop_seed, float drop_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = make_args(alibi, B, Sq, Sk, Hq, Hk, scale, causal, drop_threshold, drop_seed,
                           drop_scale);
  if (passes != 1 && passes != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (nslices < 1 || nslices > Hq / Hk) return static_cast<int>(cudaErrorInvalidValue);
#define K6F_DKV(DD)                                                                       \
  return passes == 3                                                                      \
             ? launch_dkv<DD, 3>(K6F_F(q), K6F_F(k), K6F_F(v), K6F_F(dout), K6F_F(lse),   \
                                 K6F_F(di), K6F_I(q_offset), K6F_I(kv_lens),              \
                                 static_cast<float*>(dk), static_cast<float*>(dv), nslices, \
                                 a, s)                                                    \
             : launch_dkv<DD, 1>(K6F_F(q), K6F_F(k), K6F_F(v), K6F_F(dout), K6F_F(lse),   \
                                 K6F_F(di), K6F_I(q_offset), K6F_I(kv_lens),              \
                                 static_cast<float*>(dk), static_cast<float*>(dv), nslices, \
                                 a, s)
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

// dk and dv (n floats each, n a multiple of 4) = the sums, in slice order,
// of the nslices partials in parts [2, nslices, n]: dK's, then dV's.
extern "C" int flash_bwd_f32_dkv_sum_launch(const void* parts, void* dk, void* dv, int n,
                                            int nslices, void* stream) {
  if (n % 4 != 0 || nslices < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n / 4;
  if (n4 == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(std::min((n4 + 255) / 256, 1024), 2);
  dkv_sum_kernel<<<grid, 256, 0, s>>>(
      static_cast<const float4*>(parts), static_cast<float4*>(dk), static_cast<float4*>(dv),
      n4, nslices);
  return static_cast<int>(cudaGetLastError());
}
