// K7: FP8-compute flash attention (FA3 descale semantics), forward only.
//
// Replaces llm_fp8_tpu/kernels/flash_attention.py::flash_attention_fp8 (the
// _fwd_kernel with has_descale). q [B, Sq, Hq, D], k and v [B, Sk, Hk, D] are
// e4m3 codes; qd, kd, vd [B, Hk] float32 descales. Per query row:
//   s  = dot(q8, k8) * scale * (qd * kd), then softcap, then the masks
//        (kv_len, causal with q_offset, window) as the TPU kernel's MASK_VALUE
//   per block_k-key tile t (keys [t * block_k, (t + 1) * block_k)):
//     m' = max(m, max_tile s);  alpha = exp(m - m');  p = exp(s - m')
//     l  = alpha * l + sum(p)                     (the unquantized p)
//     p8 = e4m3(p)                                 (round to nearest even, subnormals kept)
//     acc = alpha * acc + p8 @ v8                  (float32)
//   out = dead ? 0 : acc / l * vd, in bf16 or float32.
// The tile is part of the function: p8 depends on the running max m', the max
// over the tiles seen so far, so another block_k changes many e4m3 codes.
//
// Two routes, as the TPU kernel's fp8_native: NATIVE multiplies P·V e4m3 x
// e4m3 on the tensor cores; the dequant route widens every code to bf16
// with the exact hardware conversion (e4m3 -> f16 -> bf16; not the FTZ
// helpers of fp8_ftz.cuh, which flush subnormals) and multiplies bf16. Q·Kᵀ
// multiplies the e4m3 values exactly on both (e4m3 mma.sync, or bf16
// operands). Both routes compute p alike (Softmax2: the log2 domain, one
// FFMA and ex2 a score), so they differ only in their sums.
//
// Bound on the H100: operations at long sequences — 4·D FLOPs per live (query,
// key) pair at 1,979 TFLOP/s (fp8, native) or 989 (bf16, dequant); bytes (one
// byte per operand code, 2 or 4 per output value) at short ones.
//
// Two kernels, picked by the wrapper (kernels/flash_attention.py::
// fp8_wgmma_ok). The native route from 64 query rows up (the prefill and
// training shapes) runs on the wgmma kernel; decode (Sq < 64), the dequant
// route (which the H100 never picks by default: it is a route the caller
// names) and tiles too large for two stages of shared memory (block_k · D >
// 32768) run on the mma.sync kernel.
//
// The wgmma kernel: a block of 128 query rows of one (q head, batch row),
// two consumer warpgroups of 64 rows and a producer warp that keeps TMA
// loads of Q (once) and of whole block_k tiles of K and Vᵀ in a 2-stage
// mbarrier ring. A pre-pass (its own kernels, inside the call) widens Q and
// K to bf16 once and writes Vᵀ [B, Hk, D, Sk] (key-contiguous: 8-bit wgmma
// reads only K-major operands) with each 32-key group in the order in which
// a lane holds P (slot_key), so that P's e4m3 codes form P·V's A fragment
// where they stand, with no shuffles between lanes. A warpgroup takes each
// of its live 64-key chunks of a tile twice. Pass 1: S = Q·Kᵀ for the tile's
// row maxima only (the raw accumulator's max, scaled once: the scaling is
// monotone). Pass 2: S again, p (Softmax2), l summed over the unrounded p, p
// rounded to e4m3 into the A fragment of P·V, which runs as an RS wgmma
// (m64nDk32 e4m3, B the chunk's Vᵀ) beside the next chunk's Q·Kᵀ; a tile's
// products sum on the tensor cores, then into the float32 accumulator.
// Q·Kᵀ runs as a bf16 wgmma on the widened codes, not an e4m3 one: the
// e4m3 wgmma sums Q·Kᵀ's products too coarsely, and P's e4m3 codes follow
// the scores' last bits (on the H100, 12% of the prefill case's rows moved
// beyond 1 bf16 ulp, 247 beyond 4; a P·V summed on the tensor cores over a
// whole sequence, not a tile, moved 0.3% beyond 1 ulp: PERF.md).
// Tried and dropped: Q·Kᵀ on e4m3 mma.sync from the swizzled TMA tile
// (exact, but its issue slots made the kernel slower), widening K in each
// block (every block widened each K tile again), three consumer warpgroups
// (168 registers are not there for three; ptxas spilled) and the next
// chunk's Q·Kᵀ issued under this chunk's softmax (ptxas spilled, or
// serialized every wgmma: slower each time).
//
// The mma.sync kernel (the first design): one block of four warps per
// (64-query tile, q head, batch row); GQA through the head map (K/V never
// repeated). The block walks the block_k tiles that hold a live key for some
// row of the tile, in 64-key chunks (chunks with no live key are skipped, as
// the TPU kernel skips dead tiles). Each tile takes two passes over its
// chunks: the first computes S = Q·Kᵀ on the tensor cores for the row maxima;
// the second recomputes S (bit-identical), forms p and p8, stages p8 in the
// warp's shared-memory rows and multiplies it by V, which is transposed to
// [D, keys] in shared memory because both operands of an 8-bit MMA are
// K-major. Each warp owns 16 query rows; S, P and the output accumulator stay
// in the MMA fragments' registers.
#include <math.h>

#include "fp8_ftz.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64, kChunk = 64, kWarps = 4, kThreads = kWarps * 32;
// The softmax both kernels compute, in the log2 domain, so that the two
// routes differ only in their sums: a score's key is its accumulator value
// (when the scale and descales are positive and there is no softcap, the
// scaled max is the max scaled, bit for bit) or else its log2-domain score;
// a masked key is -inf, which no max takes and which gives p = 0. The
// tile max m2 is log2-domain; p = 2^(acc · scale · qk descale · log2 e − m2)
// by one FFMA and ex2 (hopper.cuh's fast_exp2, as K3 computes p). A row
// without a live key keeps m2 = -inf and l = 0: it is dead, its output 0.
// This is not the plain version's rounding (torch.exp of s − m, s rounded
// after each product), which the first mma.sync kernel reproduced with
// expf: on the H100 at the 8192 prefill, 15 rows of 262,144 end beyond 1
// bf16 ulp of the plain version (worst 3.5, the limit 4) where expf leaves
// 2 (worst 1.84). But expf in both kernels costs 1.7 ms of the native
// route's 2.0 and 2.3 ms of the dequant route's 4.5, and ex2 of the plain
// version's s − m costs 0.5 ms and leaves 9 rows beyond 1 ulp: the softmax
// loop is issue-bound (python -m llm_fp8_tpu_torch.scripts.kernel_variants
// k7-exp; PERF.md).
struct Softmax2 {
  float scale, qkd, softcap, c2;
  bool monotone;
  __device__ Softmax2(float scale_, float qkd_, float softcap_)
      : scale(scale_), qkd(qkd_), softcap(softcap_),
        c2(scale_ * qkd_ * 1.4426950408889634f),
        monotone(softcap_ <= 0.0f && scale_ > 0.0f && qkd_ > 0.0f) {}
  // The log2-domain score of accumulator value a.
  __device__ __forceinline__ float s2(float a) const {
    if (softcap > 0.0f) {
      const float x = a * scale * qkd;
      return softcap * tanhf(x / softcap) * 1.4426950408889634f;
    }
    return a * c2;
  }
  __device__ __forceinline__ float key(float a) const { return monotone ? a : s2(a); }
  // The log2-domain max from the keys' max.
  __device__ __forceinline__ float max2(float kmax) const {
    return monotone ? kmax * c2 : kmax;
  }
  // p of a key against the row's m2; m2 = -inf (no live key yet) gives 0.
  __device__ __forceinline__ float p(float k, float m2) const {
    const float mm = m2 == -INFINITY ? INFINITY : m2;
    return hopper::fast_exp2(monotone ? fmaf(k, c2, -mm) : k - mm);
  }
};

// Shared memory, in bytes. E bytes per operand element (1 native, 2 bf16).
// Row pitches are the row's bytes + 16, so the fragment loads (row gid, word
// tig) hit 32 different banks.
template <int D, bool NATIVE>
struct Smem {
  static constexpr int E = NATIVE ? 1 : 2;
  static constexpr int LQ = D * E + 16;       // Q [64][D] and K [64 keys][D]
  static constexpr int LV = kChunk * E + 16;  // Vt [D][64 keys] and P [64][64 keys]
  static constexpr int Q = 0;
  static constexpr int K = Q + kBQ * LQ;
  static constexpr int V = K + kChunk * LQ;
  static constexpr int P = V + D * LV;
  static constexpr int BYTES = P + kBQ * LV;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One e4m3 code -> its bf16 bits, exactly (subnormals kept).
__device__ __forceinline__ uint32_t e4m3_to_bf16_bits(uint32_t b) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
  return __bfloat16_as_ushort(__float2bfloat16_rn(__half2float(__half(h))));
}

// Two codes (bytes 0 and 1 of w) -> two bf16 in one word.
__device__ __forceinline__ uint32_t widen2(uint32_t w) {
  return e4m3_to_bf16_bits(w & 0xFFu) | (e4m3_to_bf16_bits((w >> 8) & 0xFFu) << 16);
}

// D += A·B for one 16x8 tile: A 16 x 32 bytes (row), B 8 x 32 bytes (col);
// 32 e4m3 or 16 bf16 values along k.
template <bool NATIVE>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (NATIVE) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// A fragment: rows r0 + gid and r0 + gid + 8, bytes col + tig*4 and +16.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* base, int pitch,
                                       int r0, int col, int gid, int tig) {
  const unsigned char* p = base + (r0 + gid) * pitch + col + tig * 4;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * pitch + 16);
}

// Copies `rows` rows of D codes (row r at src + r * stride) into shared
// memory at pitch bytes a row, widened to bf16 unless NATIVE; rows >= valid
// are zero.
template <int D, bool NATIVE>
__device__ __forceinline__ void load_rows(unsigned char* dst, int pitch, const uint8_t* src,
                                          size_t stride, int rows, int valid) {
  constexpr int CH = D / 16;
  for (int c = threadIdx.x; c < rows * CH; c += kThreads) {
    const int r = c / CH, cc = (c % CH) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + cc);
    if constexpr (NATIVE) {
      *reinterpret_cast<uint4*>(dst + r * pitch + cc) = v;
    } else {
      uint4* d = reinterpret_cast<uint4*>(dst + r * pitch + 2 * cc);
      d[0] = make_uint4(widen2(v.x), widen2(v.x >> 16), widen2(v.y), widen2(v.y >> 16));
      d[1] = make_uint4(widen2(v.z), widen2(v.z >> 16), widen2(v.w), widen2(v.w >> 16));
    }
  }
}

// V rows [key][D] -> Vt [D][64 keys]; keys >= valid are zero. A thread moves
// 4 keys x 4 values (four 4-byte loads, four transposed stores).
template <int D, bool NATIVE>
__device__ __forceinline__ void load_v_transposed(unsigned char* dst, int pitch,
                                                  const uint8_t* src, size_t stride, int valid) {
  constexpr int DG = D / 4;
  for (int t = threadIdx.x; t < (kChunk / 4) * DG; t += kThreads) {
    const int dg = t % DG, kg = t / DG;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kg * 4 + i;
      w[i] = key < valid ? *reinterpret_cast<const uint32_t*>(src + key * stride + dg * 4) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t col = 0;  // keys kg*4 .. kg*4+3 of value dg*4 + j
#pragma unroll
      for (int i = 0; i < 4; ++i) col |= ((w[i] >> (8 * j)) & 0xFFu) << (8 * i);
      unsigned char* row = dst + (dg * 4 + j) * pitch;
      if constexpr (NATIVE) {
        *reinterpret_cast<uint32_t*>(row + kg * 4) = col;
      } else {
        *reinterpret_cast<uint2*>(row + kg * 8) = make_uint2(widen2(col), widen2(col >> 16));
      }
    }
  }
}

struct Params {
  const uint8_t* q;
  const uint8_t* k;
  const uint8_t* v;
  void* out;
  const float* qd;
  const float* kd;
  const float* vd;
  const int* q_offset;
  const int* kv_lens;
  int Sq, Sk, Hq, Hk, block_k;
  float scale;
  int causal, window;
  float softcap;
};

template <int D, bool NATIVE, bool OUT_F32>
__global__ void __launch_bounds__(kThreads) flash_fp8_kernel(const Params p) {
  using L = Smem<D, NATIVE>;
  constexpr int KS = D * L::E / 32;        // k-steps of Q·Kᵀ
  constexpr int PKS = kChunk * L::E / 32;  // k-steps of P·V
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem + L::Q;
  unsigned char* Ks = smem + L::K;
  unsigned char* Vt = smem + L::V;
  unsigned char* Ps = smem + L::P;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.Hq / p.Hk);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = qt * kBQ;
  const int q_off = p.q_offset[b];
  const int kv_len = min(p.kv_lens[b], p.Sk);
  const float qkd = p.qd[b * p.Hk + kvh] * p.kd[b * p.Hk + kvh];
  const float vd = p.vd[b * p.Hk + kvh];
  const Softmax2 sm(p.scale, qkd, p.softcap);

  const size_t q_stride = static_cast<size_t>(p.Hq) * D, kv_stride = static_cast<size_t>(p.Hk) * D;
  load_rows<D, NATIVE>(Qs, L::LQ, p.q + (static_cast<size_t>(b) * p.Sq + q0) * q_stride + h * D,
                       q_stride, kBQ, p.Sq - q0);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(qa[ks], Qs, L::LQ, warp * 16, ks * 32, gid, tig);

  // Rows gid and gid + 8 of this warp: running log2-domain max, partial
  // sum (this thread's keys), output accumulator (columns jn*8 + tig*2 +
  // {0, 1}).
  const int qp0 = q_off + q0 + warp * 16 + gid;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) acc[jn][0] = acc[jn][1] = acc[jn][2] = acc[jn][3] = 0.0f;

  // Keys that are live for some row of this tile.
  const int q_min = q_off + q0, q_max = q_off + min(q0 + kBQ, p.Sq) - 1;
  const int k_lo = p.window > 0 ? max(0, q_min - p.window + 1) : 0;
  const int k_hi = p.causal ? min(kv_len, q_max + 1) : kv_len;

  const uint8_t* kb = p.k + static_cast<size_t>(b) * p.Sk * kv_stride + kvh * D;
  const uint8_t* vb = p.v + static_cast<size_t>(b) * p.Sk * kv_stride + kvh * D;

  // The keys (Softmax2) of this warp's rows and the chunk's 64 keys.
  auto scores = [&](float (&sc)[kChunk / 8][4], int kc0) {
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const unsigned char* kp = Ks + (j * 8 + gid) * L::LQ + ks * 32 + tig * 4;
        mma<NATIVE>(sc[j], qa[ks], ld32(kp), ld32(kp + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q_pos = qp0 + (e >= 2 ? 8 : 0);
        const int k_pos = kc0 + j * 8 + tig * 2 + (e & 1);
        bool live = k_pos < kv_len;
        if (p.causal) live = live && k_pos <= q_pos;
        if (p.window > 0) live = live && k_pos > q_pos - p.window;
        sc[j][e] = live ? sm.key(sc[j][e]) : -INFINITY;
      }
    }
  };

  for (int t = k_hi > k_lo ? k_lo / p.block_k : 0; t * p.block_k < k_hi && k_hi > k_lo; ++t) {
    const int c_begin = max(t * p.block_k, (k_lo / kChunk) * kChunk);
    const int c_end = min((t + 1) * p.block_k, k_hi);

    // Pass 1: the tile's row maxima.
    float mt[2] = {-INFINITY, -INFINITY};
    for (int kc0 = c_begin; kc0 < c_end; kc0 += kChunk) {
      __syncthreads();
      load_rows<D, NATIVE>(Ks, L::LQ, kb + kc0 * kv_stride, kv_stride, kChunk, p.Sk - kc0);
      __syncthreads();
      float sc[kChunk / 8][4];
      scores(sc, kc0);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
        mt[0] = fmaxf(mt[0], fmaxf(sc[j][0], sc[j][1]));
        mt[1] = fmaxf(mt[1], fmaxf(sc[j][2], sc[j][3]));
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_next = fmaxf(m[r], sm.max2(mt[r]));
      alpha[r] = m_next == -INFINITY ? 1.0f : hopper::fast_exp2(m[r] - m_next);
      m[r] = m_next;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      acc[jn][0] *= alpha[0];
      acc[jn][1] *= alpha[0];
      acc[jn][2] *= alpha[1];
      acc[jn][3] *= alpha[1];
    }

    // Pass 2: p, p8 and acc += p8 · V, chunk by chunk.
    for (int kc0 = c_begin; kc0 < c_end; kc0 += kChunk) {
      __syncthreads();
      load_rows<D, NATIVE>(Ks, L::LQ, kb + kc0 * kv_stride, kv_stride, kChunk, p.Sk - kc0);
      load_v_transposed<D, NATIVE>(Vt, L::LV, vb + kc0 * kv_stride, kv_stride, p.Sk - kc0);
      __syncthreads();
      float sc[kChunk / 8][4];
      scores(sc, kc0);
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float p0 = sm.p(sc[j][2 * hr], m[hr]);
          const float p1 = sm.p(sc[j][2 * hr + 1], m[hr]);
          l[hr] += p0 + p1;
          const uint32_t c0 = __nv_cvt_float_to_fp8(p0, __NV_SATFINITE, __NV_E4M3);
          const uint32_t c1 = __nv_cvt_float_to_fp8(p1, __NV_SATFINITE, __NV_E4M3);
          unsigned char* dst =
              Ps + (warp * 16 + gid + 8 * hr) * L::LV + (j * 8 + tig * 2) * L::E;
          if constexpr (NATIVE)
            *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(c0 | (c1 << 8));
          else
            *reinterpret_cast<uint32_t*>(dst) = widen2(c0 | (c1 << 8));
        }
      }
      __syncwarp();
      uint32_t pa[PKS][4];
#pragma unroll
      for (int ks = 0; ks < PKS; ++ks) load_a(pa[ks], Ps, L::LV, warp * 16, ks * 32, gid, tig);
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < PKS; ++ks) {
          const unsigned char* vp = Vt + (jn * 8 + gid) * L::LV + ks * 32 + tig * 4;
          mma<NATIVE>(pv, pa[ks], ld32(vp), ld32(vp + 16));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jn][e] += pv[e];
      }
    }
  }

  // Finalize: dead rows (no live key) give 0; else acc / l * vd.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = lr == 0.0f ? 0.0f : 1.0f / lr;
    const int sq = q0 + warp * 16 + gid + 8 * r;
    if (sq >= p.Sq) continue;
    const size_t o = ((static_cast<size_t>(b) * p.Sq + sq) * p.Hq + h) * D + tig * 2;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const float o0 = acc[jn][2 * r] * inv * vd, o1 = acc[jn][2 * r + 1] * inv * vd;
      if constexpr (OUT_F32)
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o + jn * 8) = make_float2(o0, o1);
      else
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o + jn * 8) =
            __floats2bfloat162_rn(o0, o1);
    }
  }
}

// ---- the wgmma kernel (native route, Sq >= 64) ----

constexpr int kWQRows = 128;        // query rows a block: two consumer warpgroups of 64
constexpr int kWThreads = 288;      // + one producer warp
constexpr int kWMaxTile = 32768;    // block_k · D at most: two stages fit in shared memory

// The key of slot j of the Vᵀ layout: within each 32-key group, slot
// 16h + 4t + u holds key 16h + 2t + (u & 1) + 8 (u >> 1), the order in which
// lane t of a quad holds p in the scores' accumulator, so that a lane's p8
// codes are the A fragment of P·V as they stand (kernels/flash_attention.py
// ::fp8_v_slots_plain is the same map).
__host__ __device__ __forceinline__ int slot_key(int j) {
  const int u = j & 3, t = (j >> 2) & 3, h = (j >> 4) & 1;
  return (j & ~31) + 16 * h + 2 * t + (u & 1) + 8 * (u >> 1);
}

// The Vᵀ pre-pass: vt [B, Hk, D, Skp] with vt[b][h][d][j] = v[b][slot_key(j)][h][d],
// zero where the key is past Sk. One block a 64-key chunk of one (b, h).
__global__ void __launch_bounds__(256)
v_slots_kernel(const uint8_t* __restrict__ v, uint8_t* __restrict__ vt, int Sk, int Hk, int D,
               int Skp) {
  __shared__ __align__(16) uint8_t tile[64][128 + 16];
  const int c0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const size_t row = static_cast<size_t>(Hk) * D;
  for (int i = threadIdx.x; i < 64 * D / 16; i += blockDim.x) {
    const int key = i / (D / 16), part = i % (D / 16);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c0 + key < Sk)
      val = *reinterpret_cast<const uint4*>(v + (static_cast<size_t>(b) * Sk + c0 + key) * row +
                                            h * D + 16 * part);
    *reinterpret_cast<uint4*>(&tile[key][16 * part]) = val;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * 4; i += blockDim.x) {
    const int d = i / 4, seg = i % 4;
    if (c0 + 16 * seg >= Skp) continue;
    __align__(16) uint8_t o[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) o[j] = tile[slot_key(16 * seg + j)][d];
    *reinterpret_cast<uint4*>(vt + ((static_cast<size_t>(b) * Hk + h) * D + d) * Skp + c0 +
                              16 * seg) = *reinterpret_cast<const uint4*>(o);
  }
}

// The Q and K pre-pass: e4m3 codes → bf16, exactly (e4m3 → f16 → float →
// bf16, the dequant route's conversion), 16 codes a thread.
__global__ void __launch_bounds__(256)
widen_kernel(const uint8_t* __restrict__ src, __nv_bfloat16* __restrict__ dst, size_t n16) {
  const size_t u = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= n16) return;
  const uint4 c = reinterpret_cast<const uint4*>(src)[u];
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * h)) & 0xFFFFu), __NV_E4M3);
      const float2 f = __half22float2(__half2(hr));
      o[2 * i + h] = hopper::pack_bf16(f.x, f.y);
    }
  uint4* d = reinterpret_cast<uint4*>(dst) + 2 * u;
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// Shared memory of the wgmma kernel: Q (bf16, hopper::Tile<D>, 128 rows),
// two stages of a block_k tile of K (bf16, Tile<D>) and of Vᵀ (block_k / 64
// chunks [D][64 keys] of codes), the barriers; every region 1024-byte
// aligned.
struct WLayout {
  int D, BK;
  __host__ __device__ int stage() const { return 3 * BK * D; }
  __host__ __device__ int k(int s) const { return 2 * kWQRows * D + s * stage(); }
  __host__ __device__ int v(int s) const { return k(s) + 2 * BK * D; }
  __host__ __device__ int bar() const { return 2 * kWQRows * D + 2 * stage(); }
  __host__ __device__ int bytes() const { return bar() + 5 * 8 + 1024; }
};

// One block: 128 query rows of one (q head, batch row), two consumer
// warpgroups of 64 rows and a producer warp that keeps TMA loads of Q
// (once) and of whole block_k tiles of K and Vᵀ in a 2-stage mbarrier ring.
// Q and K arrive widened to bf16 by the pre-pass, V in slot order. A
// warpgroup walks its live 64-key chunks of each tile twice: pass 1 takes
// S = Q·Kᵀ (bf16 wgmma SS: exact products of the e4m3 values, float32
// sums) for the tile's row maxima only; pass 2 recomputes S, forms p
// (Softmax2, as the mma.sync kernel), sums it into l and rounds it to e4m3
// straight into the A fragment of P·V (e4m3 RS wgmma, B the chunk's Vᵀ).
// A tile's P·V sums on the tensor cores, beside the next chunk's Q·Kᵀ, then
// into the float32 accumulator.
template <int D, bool OUT_F32>
__global__ void __launch_bounds__(kWThreads, 1)
flash_fp8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  using namespace hopper;
  using T = Tile<D>;
  constexpr int NH = D > 64 ? 2 : 1, DH = D / NH;  // P·V in column halves of <= 64
  const WLayout L{D, p.block_k};
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qbar = base + L.bar();
  auto full = [&](int s) { return qbar + 8 + 8u * s; };
  auto empty = [&](int s) { return qbar + 24 + 8u * s; };

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWQRows;  // heavy (late) tiles first
  const int kvh = h / (p.Hq / p.Hk);
  const int q_off = p.q_offset[b];
  const int kv_len = min(p.kv_lens[b], p.Sk);
  // The keys live for some query row in [r0, r1).
  auto key_range = [&](int r0, int r1, int& lo, int& hi) {
    const int q_min = q_off + r0, q_max = q_off + min(r1, p.Sq) - 1;
    lo = p.window > 0 ? max(0, q_min - p.window + 1) : 0;
    hi = p.causal ? min(kv_len, q_max + 1) : kv_len;
  };
  int blo, bhi;
  key_range(q0, q0 + kWQRows, blo, bhi);
  const int t_begin = blo / p.block_k;
  const int t_end = bhi > blo ? (bhi + p.block_k - 1) / p.block_k : t_begin;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warp: one thread issues every load ----
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qbar, 2 * kWQRows * D);
      for (int c = 0; c < T::NCH; ++c)
        for (int g = 0; g < 2; ++g)
          tma_load_4d(base + c * kWQRows * T::SWZ + 64 * g * T::SWZ, &tq, qbar, c * T::CW, h,
                      q0 + 64 * g, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(empty(s), ((i >> 1) - 1) & 1);
        mbar_arrive_expect_tx(full(s), L.stage());
        for (int r = 0; r < p.block_k / 64; ++r) {
          const int k0 = t * p.block_k + 64 * r;
          for (int c = 0; c < T::NCH; ++c)
            tma_load_4d(base + L.k(s) + c * p.block_k * T::SWZ + 64 * r * T::SWZ, &tk, full(s),
                        c * T::CW, kvh, k0, b);
          tma_load_4d(base + L.v(s) + r * 64 * D, &tv, full(s), k0, 0, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows r0 .. r0 + 63 ----
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = q0 + 64 * wg;
  int lo, hi;
  key_range(r0, r0 + 64, lo, hi);
  const bool rows_live = r0 < p.Sq && hi > lo;
  const int q_min = q_off + r0, q_max = q_off + min(r0 + 64, p.Sq) - 1;
  const int qp0 = q_off + r0 + 16 * warp + gid;  // query position of row gid (+ 8: gid + 8)
  const float qkd = p.qd[b * p.Hk + kvh] * p.kd[b * p.Hk + kvh];
  const float vd = p.vd[b * p.Hk + kvh];
  const Softmax2 sm(p.scale, qkd, p.softcap);
  auto live = [&](int q_pos, int k_pos) {
    bool ok = k_pos < kv_len;
    if (p.causal) ok = ok && k_pos <= q_pos;
    if (p.window > 0) ok = ok && k_pos > q_pos - p.window;
    return ok;
  };
  // Whether every key of the chunk at kc is live for every row here.
  auto chunk_full = [&](int kc) {
    bool ok = kc + 64 <= kv_len;
    if (p.causal) ok = ok && kc + 63 <= q_min;
    if (p.window > 0) ok = ok && kc > q_max - p.window;
    return ok;
  };

  float S[32], pv[NH][DH / 2], o[NH][DH / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) S[i] = 0.0f;
#pragma unroll
  for (int c = 0; c < NH; ++c)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[c][i] = pv[c][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // m: log2 domain
  uint32_t pa[2][4];  // P's A fragments of the chunk in flight

  // S = Q·Kᵀ of chunk ch of stage s's K tile (waits for it, and for the
  // P·V issued before it). Element i is row gid + 8·((i >> 1) & 1) of this
  // warp, key 8·(i >> 2) + 2·tig + (i & 1) of the chunk.
  auto scores = [&](int s, int ch) {
    fence_regs(S);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(S, T::kmajor(base, kWQRows, 64 * wg, kk),
                   T::kmajor(base + L.k(s), p.block_k, 64 * ch, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
    fence_regs(pa);
  };

  mbar_wait(qbar, 0);
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int s = it & 1;
    mbar_wait(full(s), (it >> 1) & 1);
    const int c_begin = max(t * p.block_k, (lo / 64) * 64);
    const int c_end = min((t + 1) * p.block_k, hi);
    if (rows_live && c_begin < c_end) {
      // Pass 1: the tile's row maxima over its live keys.
      float mt[2] = {-INFINITY, -INFINITY};  // of the keys
      for (int kc = c_begin; kc < c_end; kc += 64) {
        scores(s, (kc - t * p.block_k) / 64);
        if (sm.monotone && chunk_full(kc)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], S[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            if (live(qp0 + 8 * r, kc + 8 * (i >> 2) + 2 * tig + (i & 1)))
              mt[r] = fmaxf(mt[r], sm.key(S[i]));
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const float m_next = fmaxf(m[r], sm.max2(v));
        alpha[r] = m_next == -INFINITY ? 1.0f : fast_exp2(m[r] - m_next);
        m[r] = m_next;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int c = 0; c < NH; ++c)
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[c][i] *= alpha[(i >> 1) & 1];

      // Pass 2: p, summed into l unrounded and rounded to e4m3 straight
      // into P·V's A fragment (register rr of k-step kk: row gid (rr even)
      // or gid + 8, slots 4·tig (rr < 2) or 16 + 4·tig; the pre-pass put
      // V's rows in that key order).
      int n = 0;
      for (int kc = c_begin; kc < c_end; kc += 64, ++n) {
        const int ch = (kc - t * p.block_k) / 64;
        scores(s, ch);
        const bool full_chunk = chunk_full(kc);
        uint32_t p16[16];  // p8 codes of elements 2j, 2j + 1
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float pe[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * j + e, r = (i >> 1) & 1;
            pe[e] = full_chunk || live(qp0 + 8 * r, kc + 8 * (i >> 2) + 2 * tig + e)
                        ? sm.p(sm.key(S[i]), m[r]) : 0.0f;
            l[r] += pe[e];
          }
          p16[j] = __nv_cvt_float2_to_fp8x2(make_float2(pe[0], pe[1]), __NV_SATFINITE, __NV_E4M3);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int j = 8 * kk + 4 * (rr >> 1) + (rr & 1);
            pa[kk][rr] = p16[j] | (p16[j + 2] << 16);
          }
        const uint32_t vs = base + L.v(s) + ch * 64 * D;
        if (n == 0)
#pragma unroll
          for (int c = 0; c < NH; ++c) fence_regs(pv[c]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NH; ++c)
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint64_t dv = make_desc(vs + c * 64 * 64 + 32 * kk, 16, 8 * 64, 64);
            if constexpr (DH == 64) wgmma_rs_e4m3_n64(pv[c], pa[kk], dv, n > 0 || kk > 0);
            else wgmma_rs_e4m3_n32(pv[c], pa[kk], dv, n > 0 || kk > 0);
          }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(pa);
#pragma unroll
      for (int c = 0; c < NH; ++c) {
        fence_regs(pv[c]);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[c][i] += pv[c][i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with the stage
  }

  // Finalize: rows without a live key give 0; else acc / l * vd.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = lr == 0.0f ? 0.0f : 1.0f / lr;
    const int sq = r0 + 16 * warp + gid + 8 * r;
    if (sq >= p.Sq) continue;
    const size_t orow = ((static_cast<size_t>(b) * p.Sq + sq) * p.Hq + h) * D + 2 * tig;
#pragma unroll
    for (int c = 0; c < NH; ++c)
#pragma unroll
      for (int nb = 0; nb < DH / 8; ++nb) {
        const float o0 = o[c][4 * nb + 2 * r] * inv * vd, o1 = o[c][4 * nb + 2 * r + 1] * inv * vd;
        const size_t at = orow + c * 64 + 8 * nb;
        if constexpr (OUT_F32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) = make_float2(o0, o1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + at) =
              __floats2bfloat162_rn(o0, o1);
      }
  }
}

template <int D, bool OUT_F32>
int launch_wgmma(const Params& p, const void* qb, const void* kb, const void* vt, int B,
                 int Skp, cudaStream_t s) {
  if (p.Sq < 64 || p.block_k * D > kWMaxTile) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int e = encode_bshd<D>(&tq, qb, B, p.Sq, p.Hq, 64);
  if (e == 0) e = encode_bshd<D>(&tk, kb, B, p.Sk, p.Hk, 64);
  const long long Hk = p.Hk, S2 = Skp;
  if (e == 0)
    e = encode_4d(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, vt, {S2, D, Hk, B},
                  {S2, D * S2, Hk * D * S2}, {64, D, 1, 1}, 64);
  if (e != 0) return e;
  const int bytes = WLayout{D, p.block_k}.bytes();
  auto kernel = flash_fp8_wgmma_kernel<D, OUT_F32>;
  // The shared-memory limit is set once per kernel instance (a
  // function-local static), to the largest tile's, not on every launch.
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WLayout{D, kWMaxTile / D}.bytes());
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid((p.Sq + kWQRows - 1) / kWQRows, p.Hq, B);
  kernel<<<grid, kWThreads, bytes, s>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool NATIVE, bool OUT_F32>
int launch(const Params& p, int B, cudaStream_t s) {
  constexpr int bytes = Smem<D, NATIVE>::BYTES;
  auto kernel = flash_fp8_kernel<D, NATIVE, OUT_F32>;
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, const void* qb, const void* kb, const void* vt, int B, int Skp,
             int native, int out_f32, cudaStream_t s) {
  if (vt != nullptr) {
    if (!native) return static_cast<int>(cudaErrorInvalidValue);
    return out_f32 ? launch_wgmma<D, true>(p, qb, kb, vt, B, Skp, s)
                   : launch_wgmma<D, false>(p, qb, kb, vt, B, Skp, s);
  }
  if (native)
    return out_f32 ? launch<D, true, true>(p, B, s) : launch<D, true, false>(p, B, s);
  return out_f32 ? launch<D, false, true>(p, B, s) : launch<D, false, false>(p, B, s);
}

}  // namespace

// The pre-pass of the wgmma kernel: q [B, Sq, Hq, D] and k [B, Sk, Hk, D]
// e4m3 → qb and kb in bf16 (same shapes), v → vt [B, Hk, D, Skp] (Skp a
// multiple of 32, at least Sk), keys in slot order.
extern "C" int flash_fp8_prep_launch(const void* q, const void* k, const void* v, void* qb,
                                     void* kb, void* vt, int B, int Sq, int Sk, int Hq, int Hk,
                                     int D, int Skp, void* stream) {
  if (Skp % 32 != 0 || Skp < Sk || D % 16 != 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nq = static_cast<size_t>(B) * Sq * Hq * D / 16, nk = static_cast<size_t>(B) * Sk * Hk * D / 16;
  if (nq > 0)
    widen_kernel<<<static_cast<unsigned>((nq + 255) / 256), 256, 0, s>>>(
        static_cast<const uint8_t*>(q), static_cast<__nv_bfloat16*>(qb), nq);
  if (nk > 0)
    widen_kernel<<<static_cast<unsigned>((nk + 255) / 256), 256, 0, s>>>(
        static_cast<const uint8_t*>(k), static_cast<__nv_bfloat16*>(kb), nk);
  if (Skp > 0)
    v_slots_kernel<<<dim3((Skp + 63) / 64, Hk, B), 256, 0, s>>>(
        static_cast<const uint8_t*>(v), static_cast<uint8_t*>(vt), Sk, Hk, D, Skp);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v: e4m3 codes; qd, kd, vd: [B, Hk] float32; out: bf16 or float32
// (out_f32). window <= 0 and softcap <= 0 mean "off". D is 32, 64 or 128;
// block_k a multiple of 64. With qb, kb and vt (flash_fp8_prep_launch's
// outputs, Skp keys a row of vt) the native route runs on the wgmma kernel
// (Sq >= 64, block_k · D <= 32768); without, on the mma.sync kernel.
extern "C" int flash_fp8_launch(const void* q, const void* k, const void* v, const void* qb,
                                const void* kb, const void* vt, void* out, const void* qd,
                                const void* kd, const void* vd,
                                const void* q_offset, const void* kv_lens, int B, int Sq,
                                int Sk, int Skp, int Hq, int Hk, int D, int block_k,
                                float scale, int causal, int window, float softcap, int native,
                                int out_f32, void* stream) {
  if (block_k <= 0 || block_k % kChunk != 0 || Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  const Params p{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(k),
                 static_cast<const uint8_t*>(v), out, static_cast<const float*>(qd),
                 static_cast<const float*>(kd), static_cast<const float*>(vd),
                 static_cast<const int*>(q_offset), static_cast<const int*>(kv_lens), Sq, Sk,
                 Hq, Hk, block_k, scale, causal, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_d<32>(p, qb, kb, vt, B, Skp, native, out_f32, s);
    case 64: return launch_d<64>(p, qb, kb, vt, B, Skp, native, out_f32, s);
    case 128: return launch_d<128>(p, qb, kb, vt, B, Skp, native, out_f32, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
