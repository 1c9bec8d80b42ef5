// float32 products on Hopper's TF32 tensor cores, shared by K3's and K6's
// float32 instances (flash_attention_f32.cu, flash_attention_bwd_f32.cu):
// wgmma m64nNk8 .tf32 issued by each warpgroup of a block, A from registers
// and B from shared memory, and the machinery that feeds it: cp.async
// copies of float32 rows and "planes" that hold each B operand split once
// into TF32 parts. TF32 wgmma takes its shared-memory operand K-major only
// (the transpose flags are for 16-bit types), so an operand whose rows are
// the product's reduction index is written transposed by the split stage.
//
// Precision: each operand x is split into big = tf32(x) and small =
// tf32(x - big); a·b is summed as small·big + big·small + big·big in the
// tensor core's float32 accumulator (3xTF32). The dropped small·small term
// and the rounding of the small parts are about 2^-22 of each product, so
// the result keeps float32's accuracy to a few ulps. PASSES == 1 keeps
// big·big alone (single-pass TF32, 2^-11 off): the planted fault the
// checks must catch.
//
// Fragments (g = lane / 4, t = lane % 4, rows of warp w offset by 16w): the
// m64k8 A fragment a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); the m64nN accumulator holds, for each 8-column group j, (g, 8j +
// 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1). An
// accumulator tile feeds the next product as its A fragment in place when
// the product's k index is permuted within each 8-group (column t is
// k = 2t, column t + 4 is k = 2t + 1) and the B operand is stored in the
// same order: see c_as_a and split_plane_t.
//
// Planes. A plane holds an operand's R x K tile (K the reduction index) as
// TF32 words, big parts then small parts (R·K words each), in wgmma's
// K-major layout without swizzle: 8 x 4 core matrices of 128 contiguous
// bytes, element (r, k) at word ((r / 8)·(K / 4) + k / 4)·32 + (r % 8)·4 +
// k % 4; the descriptor's leading offset (to the next 4 columns) is 128
// bytes, its stride offset (to the next 8 rows) 32·K bytes. The split stage
// writes 8 rows of one core matrix a quarter-warp (no bank conflict), and
// every element is split once a tile, by one thread.
#pragma once

#include <stdint.h>

#include "hopper.cuh"

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 values (small is 0 for single-pass TF32).
template <int PASSES>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = PASSES == 3 ? to_tf32(x - __uint_as_float(big)) : 0u;
}

// One 8-column group c[0..3] of an accumulator tile as the A fragment of a
// product whose k index runs over the tile's columns: column t is k = 2t,
// column t + 4 is k = 2t + 1, so the B operand's rows 2t and 2t + 1 pair
// with them.
template <int PASSES>
__device__ __forceinline__ void c_as_a(const float* c, uint32_t (&ab)[4], uint32_t (&as)[4]) {
  split<PASSES>(c[0], ab[0], as[0]);  // row g,     k 2t
  split<PASSES>(c[2], ab[1], as[1]);  // row g + 8, k 2t
  split<PASSES>(c[1], ab[2], as[2]);  // row g,     k 2t + 1
  split<PASSES>(c[3], ab[3], as[3]);  // row g + 8, k 2t + 1
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: copies that land while the products run ----

// 16 bytes global → shared; a copy that is not `in` writes zeros and reads
// nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global → shared, zeros where not `in`.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for this thread's copies; a __syncthreads after it makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A float32 tile of D columns in shared memory: rows D + 4 floats apart, or
// (SWZ) D floats apart with each 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), which saves the padding where shared memory is short (D a
// multiple of 32) at the cost of an XOR a read. Either way an A fragment's
// reads (rows g and g + 8, columns t and t + 4) fall on 32 banks.
template <int D, bool SWZ = false>
struct F32Tile {
  static_assert(!SWZ || D % 32 == 0, "the swizzle needs a multiple of 8 chunks a row");
  static constexpr int LD = SWZ ? D : D + 4;  // floats between rows
  __device__ static __forceinline__ int at(int r, int c) {
    return r * LD + (SWZ ? ((((c >> 2) ^ (r & 7)) << 2) | (c & 3)) : c);
  }
};

// Copies rows r0..r0 + ROWS - 1 (of n) of one head of a bshd float32 tensor
// (row stride rs floats from row `base`, head offset ho) into shared-memory
// rows of the layout L (F32Tile); rows past n as zeros. All NT threads of the
// block take part.
template <int D, int ROWS, int NT, class L = F32Tile<D>>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int r0, int n, size_t base,
                                        size_t rs, size_t ho) {
  constexpr int V4 = D / 4;
#pragma unroll
  for (int it = 0; it < (ROWS * V4 + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + NT * it;
    if (ROWS * V4 % NT == 0 || i < ROWS * V4) {
      const int r = i / V4, c = (i % V4) * 4;
      const bool in = r0 + r < n;
      cp_async16(dst + L::at(r, c), in ? src + (base + r0 + r) * rs + ho + c : src, in);
    }
  }
}

// ---- planes ----

// Word offset of element (r, k) of a plane of K columns (big parts).
template <int K>
__device__ __forceinline__ int plane_at(int r, int k) {
  return (((r >> 3) * (K / 4) + (k >> 2)) << 5) + ((r & 7) << 2) + (k & 3);
}

// The split stage, row order: a raw R x K float32 tile (rows K + 4 floats
// apart) → the plane (R rows, K columns) at `pl`. A quarter-warp takes 8
// rows of one core matrix: its raw reads (rows K + 4 ≡ 4 mod 8 words apart)
// and its plane writes (128 contiguous bytes) both miss bank conflicts. All
// NT threads of the block take part.
template <int PASSES, int R, int K, int NT>
__device__ __forceinline__ void split_plane(uint32_t* pl, const float* raw) {
  constexpr int K4 = K / 4;
#pragma unroll
  for (int it = 0; it < (R * K4 + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + NT * it;
    if (R * K4 % NT != 0 && i >= R * K4) break;
    const int r = (i / (8 * K4)) * 8 + (i & 7), k4 = (i >> 3) % K4;
    const float4 x = load4(raw + r * (K + 4) + 4 * k4);
    uint4 b, s;
    split<PASSES>(x.x, b.x, s.x);
    split<PASSES>(x.y, b.y, s.y);
    split<PASSES>(x.z, b.z, s.z);
    split<PASSES>(x.w, b.w, s.w);
    const int w = plane_at<K>(r, 4 * k4);
    *reinterpret_cast<uint4*>(pl + w) = b;
    if (PASSES == 3) *reinterpret_cast<uint4*>(pl + R * K + w) = s;
  }
}

// The split stage, transposed: a raw KR x N float32 tile (KR rows N + 4
// floats apart; the product reduces over its rows) → the plane of N rows and
// KR columns, each 8-row group of the raw tile stored in the c_as_a order
// (positions 0-3 hold its rows 0, 2, 4, 6, positions 4-7 rows 1, 3, 5, 7),
// so that k = t and t + 4 of a k-step pair with an accumulator tile's
// columns 2t and 2t + 1. A warp reads 32 consecutive columns of a raw row;
// a quarter-warp writes one core matrix.
template <int PASSES, int KR, int N, int NT>
__device__ __forceinline__ void split_plane_t(uint32_t* pl, const float* raw) {
#pragma unroll
  for (int it = 0; it < (N * KR / 4 + NT - 1) / NT; ++it) {
    const int i = threadIdx.x + NT * it;
    if (N * KR / 4 % NT != 0 && i >= N * KR / 4) break;
    const int n = i % N, q4 = i / N;
    const int r0 = 8 * (q4 >> 1) + (q4 & 1);  // raw rows r0, r0 + 2, r0 + 4, r0 + 6
    const float* x = raw + r0 * (N + 4) + n;
    uint4 b, s;
    split<PASSES>(x[0], b.x, s.x);
    split<PASSES>(x[2 * (N + 4)], b.y, s.y);
    split<PASSES>(x[4 * (N + 4)], b.z, s.z);
    split<PASSES>(x[6 * (N + 4)], b.w, s.w);
    const int w = plane_at<KR>(n, 4 * q4);
    *reinterpret_cast<uint4*>(pl + w) = b;
    if (PASSES == 3) *reinterpret_cast<uint4*>(pl + N * KR + w) = s;
  }
}

// The wgmma descriptor of rows n0.. of one part (big or small) of a plane of
// K columns, at k-step kk (columns 8kk .. 8kk + 7).
template <int K>
__device__ __forceinline__ uint64_t plane_desc(const uint32_t* part, int n0, int kk) {
  const uint32_t addr = smem_addr(part + plane_at<K>(n0, 8 * kk));
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((32 * K) >> 4) << 32);  // layout type 0: no swizzle
}

// ---- the TF32 wgmma shapes the kernels issue, one asm each ----

// D[64 x 16] (+)= A·B, A (TF32, the m64k8 fragment) in registers, B TF32
// K-major in shared memory; scale_d 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] (+)= A·B, A (TF32, the m64k8 fragment) in registers, B TF32
// K-major in shared memory; scale_d 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A·B, A (TF32, the m64k8 fragment) in registers, B TF32
// K-major in shared memory; scale_d 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 80] (+)= A·B, A (TF32, the m64k8 fragment) in registers, B TF32
// K-major in shared memory; scale_d 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_tf32_n80(float (&d)[40], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A·B, A (TF32, the m64k8 fragment) in registers, B TF32
// K-major in shared memory; scale_d 0 starts the sum from zero.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  if constexpr (N == 16) wgmma_tf32_n16(d, a, desc_b, scale_d);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, desc_b, scale_d);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, desc_b, scale_d);
  else if constexpr (N == 80) wgmma_tf32_n80(d, a, desc_b, scale_d);
  else if constexpr (N == 128) wgmma_tf32_n128(d, a, desc_b, scale_d);
  else static_assert(N == 16, "no wgmma shape for this N");
}

// Keeps the compiler from reusing registers a wgmma in flight still reads
// (or, for an accumulator, from touching it before the wgmma's wait).
__device__ __forceinline__ void keep(const uint32_t (&r)[4]) {
  asm volatile("" ::"r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]));
}

template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}

// The four float32 elements of an A fragment of a tile in the layout L
// (rows r and r + 8, columns c and c + 4), loaded a k-step ahead of their
// split so that the loads' latency runs under the wgmmas.
struct ARaw {
  float x[4];
  template <class L>
  __device__ __forceinline__ void load(const float* tile, int r, int c) {
    x[0] = tile[L::at(r, c)];
    x[1] = tile[L::at(r + 8, c)];
    x[2] = tile[L::at(r, c + 4)];
    x[3] = tile[L::at(r + 8, c + 4)];
  }
  template <int PASSES>
  __device__ __forceinline__ void split(uint32_t (&ab)[4], uint32_t (&as)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32x3::split<PASSES>(x[e], ab[e], as[e]);
  }
};

// One k-step of d (+)= a·b in 3xTF32: small·big, big·small, big·big on one
// accumulator (or big·big alone), B the plane `pl` (big parts; small parts
// `small` words after) of K columns, rows n0.., k-step kk.
template <int PASSES, int N, int K>
__device__ __forceinline__ void wgmma_step(float (&d)[N / 2], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t* pl,
                                           int small, int n0, int kk, int scale_d) {
  if (PASSES == 3) {
    wgmma_tf32<N>(d, as, plane_desc<K>(pl, n0, kk), scale_d);
    wgmma_tf32<N>(d, ab, plane_desc<K>(pl + small, n0, kk), 1);
  }
  wgmma_tf32<N>(d, ab, plane_desc<K>(pl, n0, kk), PASSES == 3 ? 1 : scale_d);
}

// d = A·Bᵀ over K = D columns, for NA products at once (S = Q·Kᵀ beside
// dP = dO·Vᵀ): A[x] the warpgroup's 64 rows of the tile `a[x]` (layout L;
// this thread's fragment rows r and r + 8, r = 64·warpgroup + 16·warp + g;
// t = lane % 4), B[x] the plane `pl[x]` (N rows, D columns). The A
// fragments are split a k-step at a time into two register buffers, their
// loads a step ahead, so that step kk + 1's loads and split run while step
// kk's wgmmas do. Returns with the products done.
template <int PASSES, int N, int D, int NA, class L = F32Tile<D>>
__device__ __forceinline__ void rows_products(float (&d)[NA][N / 2], const float* const (&a)[NA],
                                              int r, int t, const uint32_t* const (&pl)[NA]) {
  constexpr int NB = 2;
  uint32_t ab[NB][NA][4], as[NB][NA][4];
  ARaw raw[2][NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) raw[0][x].template load<L>(a[x], r, t);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int s = kk % NB;
    if (kk + 1 < D / 8) {
#pragma unroll
      for (int x = 0; x < NA; ++x)
        raw[(kk + 1) & 1][x].template load<L>(a[x], r, 8 * (kk + 1) + t);
    }
    if (kk >= NB) {  // step kk - NB's wgmmas read buffer s
      hopper::wgmma_wait<NB - 1>();
#pragma unroll
      for (int x = 0; x < NA; ++x) {
        keep(ab[s][x]);
        keep(as[s][x]);
      }
    }
#pragma unroll
    for (int x = 0; x < NA; ++x) raw[kk & 1][x].template split<PASSES>(ab[s][x], as[s][x]);
    hopper::wgmma_fence();
#pragma unroll
    for (int x = 0; x < NA; ++x)
      wgmma_step<PASSES, N, D>(d[x], ab[s][x], as[s][x], pl[x], N * D, 0, kk, kk > 0);
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < NB; ++s)
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      keep(ab[s][x]);
      keep(as[s][x]);
    }
#pragma unroll
  for (int x = 0; x < NA; ++x) keep(d[x]);
}

// d (+)= A·B: A the K / 8 accumulator 8-column groups split into ab, as
// (c_as_a: rows of this warpgroup, k = K positions in the c_as_a order); B
// rows n0 .. n0 + N - 1 of the plane `pl` of R rows and K columns. Returns
// with the products done.
template <int PASSES, int N, int K, int R>
__device__ __forceinline__ void acc_product(float (&d)[N / 2], const uint32_t (&ab)[K / 8][4],
                                            const uint32_t (&as)[K / 8][4], const uint32_t* pl,
                                            int n0, int accumulate) {
  keep(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    wgmma_step<PASSES, N, K>(d, ab[kk], as[kk], pl, R * K, n0, kk, kk > 0 || accumulate);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    keep(ab[kk]);
    keep(as[kk]);
  }
  keep(d);
}

}  // namespace tf32x3
