// float32 products on the TF32 tensor cores (mma.sync m16n8k8), shared by
// K3's and K6's float32 instances (flash_attention_f32.cu,
// flash_attention_bwd_f32.cu). No wgmma takes float32 operands.
//
// Precision: each operand x is split into big = tf32(x) and small =
// tf32(x - big); a·b is summed as small·big + big·small + big·big in the
// tensor core's float32 accumulator (3xTF32). The dropped small·small term
// and the rounding of the small parts are about 2^-22 of each product, so
// the result keeps float32's accuracy to a few ulps. PASSES == 1 keeps
// big·big alone (single-pass TF32, 2^-11 off): the planted fault the
// checks must catch.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4): A (16 x 8, row major)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// k x n) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1). A C tile feeds the next product as
// its A fragment in place when the product's k index is permuted within
// each 8-group (column t is k = 2t, column t + 4 is k = 2t + 1) and the B
// operand is read in the same order: see mma_c_as_a.
#pragma once

#include <stdint.h>

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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b for one m16n8k8 step: small·big + big·small + big·big, or big·big.
template <int PASSES>
__device__ __forceinline__ void mma_f32(float (&c)[4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                        uint32_t bs0, uint32_t bs1) {
  if (PASSES == 3) {
    mma_tf32(c, as, bb0, bb1);
    mma_tf32(c, ab, bs0, bs1);
  }
  mma_tf32(c, ab, bb0, bb1);
}

// The A fragment of a row-major tile in shared memory: rows r0 + g and
// r0 + g + 8, columns k0 + t and k0 + t + 4 (ld floats between rows).
template <int PASSES>
__device__ __forceinline__ void a_frag(const float* s, int ld, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split<PASSES>(s[0], ab[0], as[0]);
  split<PASSES>(s[8 * ld], ab[1], as[1]);
  split<PASSES>(s[4], ab[2], as[2]);
  split<PASSES>(s[8 * ld + 4], ab[3], as[3]);
}

// A C tile (registers c0..c3) as the A fragment of a product whose k index
// runs over the C tile's columns: column t is k = 2t, column t + 4 is
// k = 2t + 1, so the B operand's rows 2t and 2t + 1 pair with them.
template <int PASSES>
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  split<PASSES>(c[0], ab[0], as[0]);  // row g,     k 2t
  split<PASSES>(c[2], ab[1], as[1]);  // row g + 8, k 2t
  split<PASSES>(c[1], ab[2], as[2]);  // row g,     k 2t + 1
  split<PASSES>(c[3], ab[3], as[3]);  // row g + 8, k 2t + 1
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace tf32x3
