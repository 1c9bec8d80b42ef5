// Hopper (sm_90a) building blocks shared by the port's attention kernels and
// K1's prefill kernel: mbarriers, TMA tile loads through a tensor map, wgmma
// matrix descriptors and the bf16 and e4m3 wgmma shapes the kernels issue,
// and the host-side tensor maps over a [B, S, H, D] bf16 tensor, a 2-D
// matrix and a 4-D tensor of any element type.
//
// Shared-memory tiles are written by TMA in the canonical swizzled layouts
// wgmma reads: a [rows][D] bf16 tile is stored as D / CW column chunks, each
// [rows][CW] with CW = 64 (128-byte rows, 128-byte swizzle) or, for D = 32,
// CW = 32 (64-byte rows, 64-byte swizzle). Every chunk starts on a 1024-byte
// boundary, so a descriptor's base offset is 0.
//   K-major operand (the reduction runs along D, as Q·Kᵀ's Q and K): an 8-row
//   core group is 8 x (CW * 2) bytes, so SBO = 8 rows of the chunk; LBO is
//   unused by swizzled K-major layouts (1). A 16-wide step along D adds 32
//   bytes inside the chunk's rows, or moves to the next chunk.
//   MN-major operand (the reduction runs along the rows, as P·V's V): one
//   swizzle atom spans the chunk's CW columns, and an instruction's N never
//   exceeds it, so only the stride between 8-row groups along K is read; LBO
//   and SBO both carry it. A 16-row step adds 16 rows of the chunk.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that never
// ends (a fault in the pipeline) traps after 2^26 polls instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// ---- TMA ----

// One box of a 4-D tensor map into shared memory at `dst`; completion is
// counted in bytes on `bar`. Coordinates are innermost first; elements past
// the tensor's extent are written as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (coordinates innermost first).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads by
// the async proxy (wgmma operands written by threads, not by TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence (accumulators and A fragments).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Matrix descriptor: start address, leading and stride byte offsets, and the
// swizzle (128 or 64 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle) {
  const uint64_t layout = swizzle == 128 ? 1ull : 2ull;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (layout << 62);
}

// A [rows][D] bf16 tile as TMA writes it (see the top of this file).
// D = 256 (Gemma-2) is four 64-column chunks: each TMA box stays one
// 128-byte swizzle span wide.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256, "head_dim 32, 64, 128 or 256");
  static constexpr int CW = D == 32 ? 32 : 64;  // columns per chunk
  static constexpr int NCH = D / CW;            // chunks
  static constexpr int SWZ = CW * 2;            // bytes per chunk row = swizzle span

  // K-major operand whose rows start at row0 of a tile of `rows` rows at
  // `base`; reduction step kk (columns 16kk .. 16kk + 15).
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int rows, int row0, int kk) {
    const int ch = (kk * 16) / CW, off = ((kk * 16) % CW) * 2;
    return make_desc(base + ch * rows * SWZ + row0 * SWZ + off, 16, 8 * SWZ, SWZ);
  }

  // MN-major operand: chunk ch of a tile of `rows` rows at `base`, rows
  // 16kk .. 16kk + 15 (the reduction step kk).
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int rows, int ch, int kk) {
    return make_desc(base + ch * rows * SWZ + kk * 16 * SWZ, 8 * SWZ, 8 * SWZ, SWZ);
  }
};

// 2^x by the special-function unit alone (ex2.approx.ftz: about 2 ulp,
// subnormal results flushed to 0; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats → a bf16 pair (lo in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// floor(a / c) for c > 0 (C's / truncates toward zero; positions go
// negative under split-KV's offsets).
__device__ __forceinline__ int floor_div(int a, int c) {
  const int q = a / c;
  return (a % c != 0 && a < 0) ? q - 1 : q;
}

// The segment-id and chunk masks of K3's and K6's MASKS instances (the TPU
// kernels' has_segments and attention_chunk): a query at position q_pos
// with id q_id sees key k_pos only if k_pos lies in the query's chunk,
// floor(q_pos / chunk)·chunk .. + chunk - 1 (chunk > 0), and the key's id
// equals q_id (ids non-null). Queries past Sq take id -1 and keys past Sk
// id -2, as the TPU kernel pads them, so neither ever matches.
struct SegChunk {
  const int* q_ids;   // this batch row's [Sq] query ids, or null (no segments)
  const int* kv_ids;  // its [Sk] key ids
  int Sq, Sk, chunk;  // chunk <= 0: no chunk mask

  __device__ __forceinline__ int q_id(int row) const {
    return row < Sq ? __ldg(q_ids + row) : -1;
  }
  __device__ __forceinline__ int kv_id(int key) const {
    return key < Sk ? __ldg(kv_ids + key) : -2;
  }
  // The chunk start that the query positions [q_lo, q_hi] share, or INT_MIN
  // where they span chunks (or there is no chunk).
  __device__ __forceinline__ int shared_start(int q_lo, int q_hi) const {
    if (chunk <= 0) return INT_MIN;
    const int c = floor_div(q_lo, chunk);
    return c == floor_div(q_hi, chunk) ? c * chunk : INT_MIN;
  }
  // Whether (q_pos, k_pos) survives the chunk mask (the query's chunk start
  // is `start` unless that is INT_MIN) and, with ids, whether the query's id
  // qid matches the key's id kid.
  __device__ __forceinline__ bool live(int q_pos, int start, int qid, int k_pos, int kid) const {
    if (chunk > 0) {
      if (start == INT_MIN) start = floor_div(q_pos, chunk) * chunk;
      if (k_pos < start || k_pos >= start + chunk) return false;
    }
    return q_ids == nullptr || kid == qid;
  }
  // Whether some pair of query positions [q_lo, q_hi] and keys [k_lo, k_hi]
  // is masked by them (with ids: always, as the ids are not known here).
  __device__ __forceinline__ bool cuts(int q_lo, int q_hi, int k_lo, int k_hi) const {
    if (q_ids != nullptr) return true;
    if (chunk <= 0) return false;
    const int c = floor_div(q_lo, chunk);
    return c != floor_div(q_hi, chunk) || k_lo < c * chunk || k_hi >= c * chunk + chunk;
  }
  // The chunk's bounds on the key positions that the query positions
  // [q_lo, q_hi] can see: [*lo, *hi) narrowed (tile skipping). A query
  // sees a key only in its own chunk, so the same rule, keys for queries,
  // gives the query positions that can see the keys [k_lo, k_hi].
  __device__ __forceinline__ void key_range(int q_lo, int q_hi, int* lo, int* hi) const {
    if (chunk <= 0) return;
    *lo = max(*lo, floor_div(q_lo, chunk) * chunk);
    *hi = min(*hi, floor_div(q_hi, chunk) * chunk + chunk);
  }
};

// No extra mask: the plain and EXTRA instances' (folds away).
struct AllLive {
  __device__ __forceinline__ bool cuts(int, int) const { return false; }
  __device__ __forceinline__ bool operator()(int, int) const { return true; }
};

// SegChunk for the two rows of one consumer thread (row0 and row0 + 8 at
// positions q_pos0 and + 8) in a group of 64 rows from position grp_lo: the
// rows' ids and chunk starts are read once, so a score's test is two
// compares and, with ids, one cached load of the key's id.
struct RowsLive {
  SegChunk s;
  int qid[2], cs[2];
  int cs_lo, cs_hi;  // chunk starts of the group's first and last rows

  __device__ __forceinline__ bool cuts(int k_lo, int k_hi) const {
    return s.q_ids != nullptr ||
           (s.chunk > 0 && (cs_lo != cs_hi || k_lo < cs_lo || k_hi >= cs_lo + s.chunk));
  }
  // Row r (0: row0, 1: row0 + 8) against key k_pos.
  __device__ __forceinline__ bool operator()(int r, int k_pos) const {
    return (s.chunk <= 0 || (k_pos >= cs[r] && k_pos < cs[r] + s.chunk)) &&
           (s.q_ids == nullptr || s.kv_id(k_pos) == qid[r]);
  }
};

// The extra mask of a thread's two rows: RowsLive in the MASKS instances,
// else AllLive.
template <bool MASKS>
__device__ __forceinline__ auto rows_live(const SegChunk& s, int row0, int q_pos0, int grp_lo) {
  if constexpr (MASKS) {
    const int c = s.chunk > 0 ? s.chunk : 1;
    RowsLive r{s, {0, 0}, {floor_div(q_pos0, c) * c, floor_div(q_pos0 + 8, c) * c},
               floor_div(grp_lo, c) * c, floor_div(grp_lo + 63, c) * c};
    if (s.q_ids != nullptr) {
      r.qid[0] = s.q_id(row0);
      r.qid[1] = s.q_id(row0 + 8);
    }
    return r;
  } else {
    return AllLive{};
  }
}

// A m64nNk16 accumulator (N/2 floats a thread: element i is row
// 16·warp + lane/4 + 8·((i >> 1) & 1), column 8·(i / 4) + 2·(lane % 4) + (i & 1))
// → the A fragments of the next product, which reduces over those N columns:
// step kk takes columns 16kk .. 16kk + 15 as {row g cols 2t, row g+8 cols 2t,
// row g cols 2t+8, row g+8 cols 2t+8} (pairs), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(acc[8 * kk + 2 * j], acc[8 * kk + 2 * j + 1]);
  }
}

// ---- the bf16 shapes the kernels issue, one asm each ----

// D[64 x 32] (+)= A·B with A and B in shared memory (both K-major).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A·B with A and B in shared memory (both K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A·B with A and B in shared memory (both K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A·B with A (K-major) and B (MN-major: N contiguous) in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128_bt(float (&d)[64], uint64_t desc_a,
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] += A·B, A (bf16 pairs, the m64k16 fragment) in registers,
// B in shared memory MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n32_bt(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 64] += A·B, A (bf16 pairs, the m64k16 fragment) in registers,
// B in shared memory MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs_n64_bt(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// ---- the e4m3 shapes K7's P·V issues (k = 32 bytes; B K-major, the only
// layout 8-bit wgmma reads), one asm each ----

// D[64 x 32] (+)= A·B, A (e4m3, the m64k32 fragment: four bytes of one row
// a register) in registers, B e4m3 in shared memory.
__device__ __forceinline__ void wgmma_rs_e4m3_n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A·B, A e4m3 in registers, B e4m3 in shared memory.
__device__ __forceinline__ void wgmma_rs_e4m3_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

}  // namespace hopper

// ---- host: the tensor map of a bshd tensor ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver (libcuda); it is reached through
// the runtime's driver entry point, so the libraries need no -lcuda.
static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over the bf16 tensor [B, S, H, D] at `ptr`, whose box is one
// column chunk (Tile<D>::CW columns) of `rows` rows of one head and batch
// row, swizzled as Tile<D> says. Rows past S read as zeros. Returns a CUDA
// error code (0 on success).
template <int D>
static inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int rows) {
  using T = hopper::Tile<D>;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::CW), 1u, static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            T::SWZ == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A tensor map over the row-major matrix [rows, cols] of `elem` bytes per
// element at `ptr` (rows `row_bytes` apart), whose box is box_rows x
// box_cols; swizzle 128 (the box's rows must then be 128 bytes) or 0. Reads
// past the matrix are zeros. Returns a CUDA error code (0 on success).
static inline int encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
                            long long rows, long long cols, long long row_bytes, int box_rows,
                            int box_cols, int swizzle) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1u, 1u};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A tensor map over the 4-D tensor at `ptr` (dims and box innermost first,
// strides in bytes of dims 1..3), swizzle 128, 64 or 0 bytes (the box's
// inner extent in bytes must then equal it). Reads past the tensor are
// zeros. Returns a CUDA error code (0 on success).
static inline int encode_4d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
                            const long long (&dims)[4], const long long (&strides)[3],
                            const int (&box)[4], int swizzle) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (long long st : strides)
    if (st % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4];
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  for (int i = 0; i < 4; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) st[i] = static_cast<cuuint64_t>(strides[i]);
  const CUtensorMapSwizzle sw = swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, dtype, 4, const_cast<void*>(ptr), d, st, bx, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
