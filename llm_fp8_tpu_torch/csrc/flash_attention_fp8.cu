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
// Two routes, as the TPU kernel's fp8_native: NATIVE multiplies e4m3 x e4m3
// on the tensor cores (mma.sync m16n8k32 e4m3, sm_89+); the dequant route
// widens every code to bf16 with the exact hardware conversion (e4m3 -> f16 ->
// bf16; not the FTZ helpers of fp8_ftz.cuh, which flush subnormals) and
// multiplies bf16 (mma.sync m16n8k16). The products are exact on both routes;
// only the accumulation differs. Each 64-key chunk's P·V product starts from
// zero in the MMA and is added to the float32 accumulator in registers, so no
// sum runs across chunks inside the tensor cores.
//
// Bound on the H100: operations at long sequences — 4·D FLOPs per live (query,
// key) pair at 1,979 TFLOP/s (fp8, native) or 989 (bf16, dequant); bytes (one
// byte per operand code, 2 or 4 per output value) at short ones.
//
// Design (simple first; wgmma and TMA are later work): one block of four warps
// per (64-query tile, q head, batch row); GQA through the head map (K/V never
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

namespace {

constexpr int kBQ = 64, kChunk = 64, kWarps = 4, kThreads = kWarps * 32;
constexpr float kMask = -0.7f * 3.4028234663852886e38f;

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

  const size_t q_stride = static_cast<size_t>(p.Hq) * D, kv_stride = static_cast<size_t>(p.Hk) * D;
  load_rows<D, NATIVE>(Qs, L::LQ, p.q + (static_cast<size_t>(b) * p.Sq + q0) * q_stride + h * D,
                       q_stride, kBQ, p.Sq - q0);
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(qa[ks], Qs, L::LQ, warp * 16, ks * 32, gid, tig);

  // Rows gid and gid + 8 of this warp: running max, partial sum (this
  // thread's keys), output accumulator (columns jn*8 + tig*2 + {0, 1}).
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

  // S for this warp's rows and the chunk's 64 keys, scaled, capped, masked.
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
        float x = sc[j][e] * p.scale;
        x = x * qkd;
        if (p.softcap > 0.0f) x = p.softcap * tanhf(x / p.softcap);
        bool live = k_pos < kv_len;
        if (p.causal) live = live && k_pos <= q_pos;
        if (p.window > 0) live = live && k_pos > q_pos - p.window;
        sc[j][e] = live ? x : kMask;
      }
    }
  };

  for (int t = k_hi > k_lo ? k_lo / p.block_k : 0; t * p.block_k < k_hi && k_hi > k_lo; ++t) {
    const int c_begin = max(t * p.block_k, (k_lo / kChunk) * kChunk);
    const int c_end = min((t + 1) * p.block_k, k_hi);

    // Pass 1: the tile's row maxima.
    float mt[2] = {kMask, kMask};
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
      const float m_next = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - m_next);
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
          const float p0 = expf(sc[j][2 * hr] - m[hr]);
          const float p1 = expf(sc[j][2 * hr + 1] - m[hr]);
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
    const bool dead = (lr == 0.0f) || (m[r] <= kMask * 0.5f);
    const float inv = dead ? 0.0f : 1.0f / lr;
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

template <int D, bool NATIVE, bool OUT_F32>
int launch(const Params& p, int B, cudaStream_t s) {
  constexpr int bytes = Smem<D, NATIVE>::BYTES;
  auto kernel = flash_fp8_kernel<D, NATIVE, OUT_F32>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, B);
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int B, int native, int out_f32, cudaStream_t s) {
  if (native)
    return out_f32 ? launch<D, true, true>(p, B, s) : launch<D, true, false>(p, B, s);
  return out_f32 ? launch<D, false, true>(p, B, s) : launch<D, false, false>(p, B, s);
}

}  // namespace

// q, k, v: e4m3 codes; qd, kd, vd: [B, Hk] float32; out: bf16 or float32
// (out_f32). window <= 0 and softcap <= 0 mean "off". D is 32, 64 or 128;
// block_k a multiple of 64.
extern "C" int flash_fp8_launch(const void* q, const void* k, const void* v, void* out,
                                const void* qd, const void* kd, const void* vd,
                                const void* q_offset, const void* kv_lens, int B, int Sq,
                                int Sk, int Hq, int Hk, int D, int block_k, float scale,
                                int causal, int window, float softcap, int native, int out_f32,
                                void* stream) {
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
    case 32: return launch_d<32>(p, B, native, out_f32, s);
    case 64: return launch_d<64>(p, B, native, out_f32, s);
    case 128: return launch_d<128>(p, B, native, out_f32, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
