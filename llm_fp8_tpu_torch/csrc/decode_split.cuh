// The split single-token decode shared by K2 (csrc/decode_attention.cu, the
// KV arena) and K5 (csrc/paged_attention.cu, the paged pool): one block of
// four warps per (kv head, sequence, split) attends the split's keys
// [lo, hi) and writes a float32 partial (per grouped q head its max, its
// sum and its unnormalized output row); a second kernel merges a
// sequence's partials in split order. The two kernels differ only in where
// a key's row lives (the arena's contiguous rows, or a page through the
// block table: the `RowOf` functor), in how they fold q, and in how they
// append the new token; both leave the walk and the merge to this file.
//
// The walk: each warp takes the 32-key groups lo + warp·32, lo + warp·32 +
// 128, ... of [lo, hi). A lane copies its key's K and V rows (16-byte
// cp.async) into the warp's double-buffered stage while the warp works on
// the group before; the first group is issued (`prefetch`) before the
// kernel folds q and appends, so the first load's latency hides behind
// them. q·k and P·V run on mma.sync bf16 tiles (the Walk struct says how
// the fragments are laid out): the codes are dequantized four at a time
// into bf16 pairs, and each warp keeps its own online softmax, with p
// rounded to bf16 before P·V as the TPU kernels round it. A first form kept
// both products on CUDA cores (a lane scoring its key for every q head,
// then 32 keys of p·v per lane); its walk was most of the arena decode
// call. The row at position `last` (the appended token) is
// never read from device memory: the kernel's shared copy of its codes
// stands in, so no thread reads back what another block just wrote. The
// block merges its warps in warp order into the split's partial.
//
// ALiBi (when the caller passes its kv head's slopes) adds slope·(t - qpos)
// to head g's score of key t after softcap, qpos = length - 1 being the
// decode token's position.
//
// The merge applies 1/sum and the V descale and is the same order every
// run, so two runs are bit-identical (no float atomics). A split with no
// live key writes max -inf and sum 0 and returns early; the merge skips it.
#pragma once

#include <math.h>

#include "fp8_ftz.cuh"

namespace decode_split {

constexpr int kWarps = 4, kThreads = kWarps * 32, kMaxG = 8;

// Quantizes one new-token element as the TPU kernels do (divide with
// __fdiv_rn, clip to ±fmax for the narrow kinds, round to nearest even) and
// writes its code to the cache row and to `copy`, the shared-memory row the
// walk reads in its place.
template <int KIND>
__device__ __forceinline__ void store_code(uint8_t* row, uint8_t* copy, int d, float x,
                                           float scale) {
  if constexpr (KIND == kCodeBF16) {
    const __nv_bfloat16 h = __float2bfloat16_rn(__fdiv_rn(x, scale));
    reinterpret_cast<__nv_bfloat16*>(row)[d] = h;
    reinterpret_cast<__nv_bfloat16*>(copy)[d] = h;
  } else {
    const float fmax = kind_max<KIND>();
    const uint8_t c = float_to_code<KIND>(fminf(fmaxf(__fdiv_rn(x, scale), -fmax), fmax));
    row[d] = c;
    copy[d] = c;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copies 16 bytes, of which the first `n` (16 or 0) come from src and the
// rest are zero.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float32 partials of every (sequence, kv head, split): per grouped q
// head its running max, its sum and its unnormalized output row.
struct Partials {
  float* m;  // [B, Hk, splits, G]
  float* l;  // [B, Hk, splits, G]
  float* o;  // [B, Hk, splits, G, D]
};

// A warp-level bf16 tensor-core product, D += A·B (m16n8k16, float32 sums).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats → a bf16 pair (lo in the low half), rounded to nearest even.
__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four stored one-byte codes (bytes b0..b3 of w) → their bf16 values, two a
// word: lo = (b0, b1), hi = (b2, b3). fp8 by the TPU kernels' route: codes
// with a zero exponent field keep only their sign (the field plus itself
// carries into bit 7 unless it is 0, and a sign-replicating prmt spreads
// that bit over the byte); each code's 7 payload bits are shifted into a
// bf16 half and its sign moved to bit 15 by adding a multiple of itself
// (the bits between are 0, so no carry leaves the half); one exact bf16x2
// multiply by 2^120 (e4m3) or 2^112 (e5m2) rebiases. With E5M2_EXACT (K1's
// weights, which quant_matmul_plain converts exactly) e5m2 keeps its
// subnormals: it is an fp16's top byte. int8 converts exactly: v + 128 in
// the low byte of 2^23's float pattern, less 2^23 + 128.
template <int KIND, bool E5M2_EXACT = false>
__device__ __forceinline__ void codes4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (KIND == kCodeInt8) {
    const uint32_t u = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - 8388736.0f;
    lo = pack2_bf16(f[0], f[1]);
    hi = pack2_bf16(f[2], f[3]);
  } else if constexpr (KIND == kCodeE5M2 && E5M2_EXACT) {
    uint32_t h0 = __byte_perm(w, 0u, 0x1404), h1 = __byte_perm(w, 0u, 0x3424);
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&h0));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&h1));
    lo = pack2_bf16(a.x, a.y);
    hi = pack2_bf16(b.x, b.y);
  } else {
    constexpr uint32_t kExp = KIND == kCodeE4M3 ? 0x78787878u : 0x7C7C7C7Cu;
    constexpr uint32_t kShift = KIND == kCodeE4M3 ? 4 : 5;
    constexpr uint32_t kSign = 0x00800080u << kShift;      // the sign after the shift
    constexpr uint32_t kMove = (1u << (8 - kShift)) - 1u;  // to bit 15: add it this often
    constexpr uint32_t kRebias = KIND == kCodeE4M3 ? 0x7B807B80u : 0x77807780u;
    uint32_t keep;
    asm("prmt.b32 %0, %1, %2, 0xBA98;\n" : "=r"(keep) : "r"((w & kExp) + kExp), "r"(0u));
    w &= keep | 0x80808080u;
    const uint32_t u0 = __byte_perm(w, 0u, 0x4140) << kShift;
    const uint32_t u1 = __byte_perm(w, 0u, 0x4342) << kShift;
    const uint32_t p0 = u0 + (u0 & kSign) * kMove, p1 = u1 + (u1 & kSign) * kMove;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(lo) : "r"(p0), "r"(kRebias), "r"(0x80008000u));
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(hi) : "r"(p1), "r"(kRebias), "r"(0x80008000u));
  }
}

// Bytes of dynamic shared memory the walk's stage takes: per warp [2
// buffers][K, V][32 rows][row bytes + 16 of padding].
template <int D, int KIND>
constexpr int stage_bytes() {
  return kWarps * 2 * 2 * 32 * (D * (KIND == kCodeBF16 ? 2 : 1) + 16);
}

// One split's walk over the keys [lo, hi) of one (kv head, sequence).
// row_of(t) is the byte offset of key t's row from k_base (and v_base).
//
// Both products run on mma.sync m16n8k16 with bf16 operands and float32
// sums; r = lane / 4 and c = lane % 4 below. Scores S^T = K·q^T take a
// 16-key tile as A (rows: keys) and q as B (n: the 8 q heads of the group,
// zero past G); each k step of 16 dims is permuted so that a lane's A and B
// elements are dims 4c..4c+3 (one 32-bit load of codes). P·V is computed as
// out^T = V^T·P^T: A is 16 dims of V for 16 keys, with the tile's rows
// r and r+8 mapped to dims r·D/8 + 2i and +1 (tile i), so that a lane's
// dims of one key are D/8 contiguous codes; B is p (bf16) through shared
// memory. The score fragment's columns (heads 2c, 2c+1) are the output
// fragment's, so a lane rescales its own sums.
template <int D, int KIND, class RowOf>
struct Walk {
  static constexpr int ES = KIND == kCodeBF16 ? 2 : 1;  // bytes per stored element
  static constexpr int ROW = D * ES;                      // bytes per token row
  static constexpr int RP = ROW + 16;                     // staged row stride (no bank conflicts)
  static constexpr int CH = ROW / 16;                     // 16-byte chunks per row
  static constexpr int KS = D / 16;                       // 16-dim steps of the scores
  static constexpr int VW = D / 8 * ES / 4;               // words of a lane's V dims

  const uint8_t* k_base;
  const uint8_t* v_base;
  RowOf row_of;
  int lo, hi, last;  // last: the appended position, if this split holds it, else -1
  uint8_t* stage;  // this warp's stage
  int warp, lane;

  __device__ Walk(const uint8_t* k, const uint8_t* v, RowOf rows, int lo_, int hi_, int last_,
                  uint8_t* stage_all)
      : k_base(k), v_base(v), row_of(rows), lo(lo_), hi(hi_),
        last(last_ >= lo_ && last_ < hi_ ? last_ : -1),
        warp(threadIdx.x / 32), lane(threadIdx.x % 32) {
    stage = stage_all + static_cast<size_t>(warp) * 2 * 2 * 32 * RP;
  }

  __device__ uint8_t* stage_k(int buf) const { return stage + (buf * 2 + 0) * 32 * RP; }
  __device__ uint8_t* stage_v(int buf) const { return stage + (buf * 2 + 1) * 32 * RP; }
  __device__ int first() const { return lo + warp * 32; }

  // A lane copies key base+lane's K and V rows into buffer `buf`; past hi
  // it zero-fills them (their scores are masked, and a zero row adds
  // nothing to P·V). The appended row is read from the shared copy.
  __device__ void issue(int base, int buf) const {
    const int t = base + lane;
    if (t != last) {
      const bool live = t < hi;
      const size_t off = live ? row_of(t) : 0;
      const int n = live ? 16 : 0;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        cp_async16_zfill(stage_k(buf) + lane * RP + c * 16, k_base + off + c * 16, n);
        cp_async16_zfill(stage_v(buf) + lane * RP + c * 16, v_base + off + c * 16, n);
      }
    }
    cp_async_commit();
  }

  // Issues the warp's first group; call before folding q and appending.
  __device__ void prefetch() const {
    if (first() < hi) issue(first(), 0);
  }

  // The online softmax over the warp's groups, then the block's merge into
  // the partial at rows row0 .. row0+G-1. q_b is [kMaxG][D] bf16 (rows past
  // G zero), new_code the appended K and V rows; the caller has synchronised
  // the block after writing both. slopes: the G ALiBi slopes of this kv
  // head's q heads (null: no bias); qpos: the decode token's position.
  __device__ void attend(const __nv_bfloat16 (*q_b)[D], const uint8_t (*new_code)[ROW], int G,
                         float softcap, const float* slopes, int qpos, Partials part,
                         size_t row0) const {
    __shared__ __align__(16) float acc_w[kWarps][kMaxG][D];
    __shared__ __align__(16) __nv_bfloat16 p_s[kWarps][kMaxG][32];
    __shared__ float m_w[kWarps][kMaxG], l_w[kWarps][kMaxG];
    const int r = lane >> 2, c = lane & 3;

    uint32_t qf[KS][2];  // q as the scores' B fragments, for the whole walk
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const uint2 v = *reinterpret_cast<const uint2*>(&q_b[r][16 * j + 4 * c]);
      qf[j][0] = v.x;
      qf[j][1] = v.y;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // heads 2c, 2c+1
    float sl[2] = {0.0f, 0.0f};  // their ALiBi slopes
    if (slopes != nullptr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) sl[e] = 2 * c + e < G ? slopes[2 * c + e] : 0.0f;
    }
    float acc[KS][4];
#pragma unroll
    for (int i = 0; i < KS; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

    constexpr int step = kWarps * 32;
    int buf = 0;
    for (int base = first(); base < hi; base += step, buf ^= 1) {
      if (base + step < hi) issue(base + step, buf ^ 1);
      else cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();

      // Scores of the group's two 16-key tiles: s[tt] = (key r, head 2c),
      // (r, 2c+1), (r+8, 2c), (r+8, 2c+1) of tile tt.
      float s[2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s[tt][k] = 0.0f;
        const int kl = 16 * tt + r;
        const uint8_t* k0 = base + kl == last ? new_code[0] : stage_k(buf) + kl * RP;
        const uint8_t* k1 = base + kl + 8 == last ? new_code[0] : stage_k(buf) + (kl + 8) * RP;
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          uint32_t a[4];
          if constexpr (ES == 1) {
            codes4_to_bf16x2<KIND>(*reinterpret_cast<const uint32_t*>(k0 + 16 * j + 4 * c), a[0],
                                   a[2]);
            codes4_to_bf16x2<KIND>(*reinterpret_cast<const uint32_t*>(k1 + 16 * j + 4 * c), a[1],
                                   a[3]);
          } else {
            const uint2 w0 = *reinterpret_cast<const uint2*>(k0 + 32 * j + 8 * c);
            const uint2 w1 = *reinterpret_cast<const uint2*>(k1 + 32 * j + 8 * c);
            a[0] = w0.x;
            a[2] = w0.y;
            a[1] = w1.x;
            a[3] = w1.y;
          }
          mma16816(s[tt], a, qf[j][0], qf[j][1]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v = s[tt][k];
          const int t = base + kl + (k >= 2 ? 8 : 0);
          if (softcap > 0.0f) v = softcap * tanhf(v / softcap);
          if (slopes != nullptr)
            v = __fadd_rn(v, __fmul_rn(sl[k & 1], static_cast<float>(t - qpos)));
          s[tt][k] = t < hi ? v : -INFINITY;
        }
      }

      // Online softmax for heads 2c and 2c+1 over the group's 32 keys (the
      // lanes of one c hold them all: r and the two tiles); s becomes p.
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(fmaxf(s[0][e], s[0][e + 2]), fmaxf(s[1][e], s[1][e + 2]));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[e], mx);
        const float alpha = expf(m[e] - m_new);
        float ps = 0.0f;
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int k = e; k < 4; k += 2) {
            s[tt][k] = expf(s[tt][k] - m_new);
            ps += s[tt][k];
          }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[e] = alpha * l[e] + ps;
#pragma unroll
        for (int i = 0; i < KS; ++i) {
          acc[i][e] *= alpha;
          acc[i][e + 2] *= alpha;
        }
        m[e] = m_new;
      }
      // p rounded to bf16 (as the TPU kernels round it) into [head][key].
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          p_s[warp][2 * c + (k & 1)][16 * tt + r + (k >= 2 ? 8 : 0)] = __float2bfloat16_rn(s[tt][k]);
      __syncwarp();

      // P·V: per 16-key step, the lane's keys 2c, 2c+1, 2c+8, 2c+9.
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&p_s[warp][r][16 * ks + 2 * c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&p_s[warp][r][16 * ks + 2 * c + 8]);
        uint32_t vw[4][VW];  // the lane's D/8 dims of each of its four keys
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kl = 16 * ks + 2 * c + (u & 1) + (u >> 1) * 8;
          const uint8_t* row = (base + kl == last ? new_code[1] : stage_v(buf) + kl * RP) +
                               r * (VW * 4);
#pragma unroll
          for (int w = 0; w < VW; w += (VW >= 4 ? 4 : VW)) {
            if constexpr (VW >= 4) {
              const uint4 x = *reinterpret_cast<const uint4*>(row + 4 * w);
              vw[u][w] = x.x;
              vw[u][w + 1] = x.y;
              vw[u][w + 2] = x.z;
              vw[u][w + 3] = x.w;
            } else if constexpr (VW == 2) {
              const uint2 x = *reinterpret_cast<const uint2*>(row);
              vw[u][0] = x.x;
              vw[u][1] = x.y;
            } else {
              vw[u][0] = *reinterpret_cast<const uint32_t*>(row);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < KS; ++i) {  // dim tile i: dims r·D/8 + 2i, +1
          uint32_t a[4];
          if constexpr (ES == 1) {
            const int w = i >> 1;
            const uint32_t sel = (i & 1) ? 0x7362u : 0x5140u;
            codes4_to_bf16x2<KIND>(__byte_perm(vw[0][w], vw[1][w], sel), a[0], a[1]);
            codes4_to_bf16x2<KIND>(__byte_perm(vw[2][w], vw[3][w], sel), a[2], a[3]);
          } else {
            a[0] = __byte_perm(vw[0][i], vw[1][i], 0x5410);
            a[1] = __byte_perm(vw[0][i], vw[1][i], 0x7632);
            a[2] = __byte_perm(vw[2][i], vw[3][i], 0x5410);
            a[3] = __byte_perm(vw[2][i], vw[3][i], 0x7632);
          }
          mma16816(acc[i], a, b0, b1);
        }
      }
      __syncwarp();  // the group after next overwrites this buffer and p_s
    }
    cp_async_wait<0>();

    // Merge the warps' partial softmaxes (in warp order) into the split's
    // partial.
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int d = r * (D / 8) + 2 * i;
      acc_w[warp][2 * c][d] = acc[i][0];
      acc_w[warp][2 * c + 1][d] = acc[i][1];
      acc_w[warp][2 * c][d + 1] = acc[i][2];
      acc_w[warp][2 * c + 1][d + 1] = acc[i][3];
    }
    if (r == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m_w[warp][2 * c + e] = m[e];
        l_w[warp][2 * c + e] = l[e];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float M = -INFINITY;
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_w[w][g]);
      float Lsum = 0.0f, O = 0.0f;
      if (M != -INFINITY) {
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(m_w[w][g] - M);
          Lsum += l_w[w][g] * f;
          O += acc_w[w][g][d] * f;
        }
      }
      part.o[(row0 + g) * D + d] = O;
      if (d == 0) {
        part.m[row0 + g] = M;
        part.l[row0 + g] = Lsum;
      }
    }
  }
};

// The partial of a split with no live key: max -inf, sum 0 (its output row
// is never read).
__device__ __forceinline__ void empty_partial(Partials part, size_t row0, int G) {
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part.m[row0 + g] = -INFINITY;
    part.l[row0 + g] = 0.0f;
  }
}

// Merges the splits of one (kv head, sequence) in split order: out = Σ o·f
// · (1/Σ l·f · descale), f = exp(m - max m), descale v_scale[kv head] (or
// v_mult when v_scale is null); 0 where no key was live (a zero-length
// sequence). Splits without live keys are skipped. One thread per output
// (G·D ≤ 1024 threads): the splits' maxima and sums are staged in shared
// memory, then each thread loads its output's eight splits at a time, so
// the merge waits on memory twice (128 threads with two outputs each
// waited once more).
template <int D>
__global__ void __launch_bounds__(kMaxG * D)
combine_kernel(Partials part, __nv_bfloat16* __restrict__ out, int Hq, int Hk, int splits,
               const float* __restrict__ v_scale, float v_mult) {
  extern __shared__ float ml_s[];  // [splits][G] maxima, then [splits][G] sums
  const int kvh = blockIdx.x, b = blockIdx.y, G = Hq / Hk;
  const size_t base = (static_cast<size_t>(b) * Hk + kvh) * splits;
  float* m_s = ml_s;
  float* l_s = ml_s + splits * G;
  for (int i = threadIdx.x; i < splits * G; i += blockDim.x) {
    m_s[i] = part.m[base * G + i];
    l_s[i] = part.l[base * G + i];
  }
  __syncthreads();
  const int g = threadIdx.x / D, d = threadIdx.x % D;  // blockDim.x == G·D
  float M = -INFINITY;
  for (int z = 0; z < splits; ++z) M = fmaxf(M, m_s[z * G + g]);
  float Lsum = 0.0f, O = 0.0f;
  if (M != -INFINITY) {
    const float* o = part.o + (base * G + g) * D + d;
#pragma unroll 8
    for (int z = 0; z < splits; ++z) {
      const float oz = o[static_cast<size_t>(z) * G * D];  // read even if unused
      const float mz = m_s[z * G + g];
      if (mz != -INFINITY) {
        const float f = expf(mz - M);
        Lsum += l_s[z * G + g] * f;
        O += oz * f;
      }
    }
  }
  const float vs = v_scale != nullptr ? v_scale[kvh] : v_mult;
  const float l_inv = Lsum == 0.0f ? 1.0f : 1.0f / Lsum;
  out[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] =
      __float2bfloat16_rn(O * __fmul_rn(l_inv, vs));
}

// Dynamic shared memory of combine_kernel; a plan with more splits than
// fit 48 KiB is refused by the launchers.
__host__ __device__ constexpr int combine_bytes(int splits, int G) {
  return 2 * splits * G * static_cast<int>(sizeof(float));
}

}  // namespace decode_split
