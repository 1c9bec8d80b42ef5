// K2: single-token decode attention over the KV arena, with the new token's
// rotary, quantize and append done in the kernel.
//
// Replaces llm_fp8_tpu/kernels/decode_attention.py::decode_attention_arena
// (Pallas _kernel). Features: append of the new K/V token at lengths-1,
// in-kernel rotary of q and the new K, per-KV-head k/v descales, GQA, sliding
// window and softcap, over e4m3, e5m2, int8 and bf16 arenas.
//
// Layout: the arena is [L, B, Hk, S, D] here, not the TPU's lane-major
// [L, B, Hk, D, S]: each token's D codes are contiguous, so a lane reads a
// whole key row with 16-byte loads and a warp reads 32 neighbouring rows. The
// TPU kernel's 128-lane tile read-modify-write of the append was an artifact
// of that layout; here the block that owns (b, kv head) writes the one token.
//
// Bound on the H100: the arena bytes, 2·len·Hk·D per sequence and layer (at
// B 8, Hk 8, D 64 and len 1024 in fp8: 8.4 MB → 2.5 µs at 3.35 TB/s); the
// FLOPs are 2 per byte, far below the ridge.
//
// Design: one block of eight warps per (kv head, batch row). It quantizes
// the new token exactly as the TPU kernel does (divide by the head's scale,
// clip to ±fmax, round to nearest even) and stores it; the attention then
// reads the new token's codes from a shared-memory copy for position
// lengths-1, so no thread reads back what another just wrote. q is rotated,
// multiplied by scale·k_descale and rounded to bf16 once (the TPU kernel's
// folding), the V descale is applied in the epilogue. Each lane loads one key
// row and its value row together and scores the key for all grouped q heads;
// the value rows are staged in shared memory for the warp's PV sum. Each warp
// keeps its own online softmax over its rows, with p rounded to bf16 before
// the PV sum as on the TPU, and the warps' partial results are merged at the
// end. Keys outside the window are never read. Only 64 blocks run at the
// 1B decode shape (B 8 × Hk 8), so the kernel is latency-bound well above the
// byte bound; splitting the sequence across blocks is later work.
#include <math.h>

#include "fp8_ftz.cuh"

namespace {

constexpr int kWarps = 8, kThreads = kWarps * 32, kMaxG = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rotate-half rotary of element d of the row x (float32, in shared memory),
// written as the TPU kernel computes it: x*cos + rot(x)*sin, no fused
// multiply-add, so the stored codes match the plain version bit for bit.
template <int D>
__device__ __forceinline__ float rope_at(const float* x, int d, const float* cos,
                                         const float* sin) {
  constexpr int H = D / 2;
  const int i = d < H ? d : d - H;
  const float rot = d < H ? -x[d + H] : x[d - H];
  return __fadd_rn(__fmul_rn(x[d], cos[i]), __fmul_rn(rot, sin[i]));
}

template <int KIND>
__device__ __forceinline__ float load_code(const uint8_t* row, int d) {
  if constexpr (KIND == kCodeBF16)
    return bf16_bits_to_float(reinterpret_cast<const uint16_t*>(row)[d]);
  else
    return code_to_float<KIND>(row[d]);
}

// Quantizes one new-token element: writes its code to the arena row and to
// `copy` (a shared-memory row the attention then reads in its place).
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

template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
decode_arena_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_arena,
                    uint8_t* v_arena, const int* __restrict__ lengths, int layer,
                    const __nv_bfloat16* __restrict__ new_k,
                    const __nv_bfloat16* __restrict__ new_v,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    __nv_bfloat16* __restrict__ out, int B, int Hq, int Hk, int S,
                    float scale, int window, float softcap) {
  constexpr int ES = KIND == kCodeBF16 ? 2 : 1;  // bytes per stored element
  constexpr int ROW = D * ES;                      // bytes per token row
  constexpr int DPL = D / 32;                      // output dims per lane
  // `big` holds the raw q rows in steps 1-2 and the warps' partial outputs
  // in step 4 (D = 128 would not fit the 48 KB of static shared memory).
  __shared__ __align__(16) float big[kWarps * kMaxG * D];
  __shared__ float q_s[kMaxG][D];
  __shared__ float raw_s[2][D];
  __shared__ __align__(16) uint8_t new_code[2][ROW];  // the appended K and V rows
  __shared__ float p_s[kWarps][kMaxG][32];
  __shared__ float m_w[kWarps][kMaxG], l_w[kWarps][kMaxG];
  float (*q_raw)[D] = reinterpret_cast<float (*)[D]>(big);
  float (*acc_w)[kMaxG][D] = reinterpret_cast<float (*)[kMaxG][D]>(big);
  // Dynamic shared memory: each warp's 32 staged V rows.
  extern __shared__ __align__(16) uint8_t v_stage_all[];
  uint8_t* v_stage = v_stage_all + static_cast<size_t>(threadIdx.x / 32) * 32 * ROW;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int length = min(lengths[b], S);
  const float ks = k_scale[kvh], vs = v_scale[kvh];
  const size_t head = ((static_cast<size_t>(layer) * B + b) * Hk + kvh) * S;
  uint8_t* k_rows = k_arena + head * ROW;
  uint8_t* v_rows = v_arena + head * ROW;
  const bool append = new_k != nullptr, rope = cos != nullptr;
  const float* cb = rope ? cos + static_cast<size_t>(b) * (D / 2) : nullptr;
  const float* sb = rope ? sin + static_cast<size_t>(b) * (D / 2) : nullptr;

  // 1. Raw inputs into shared memory (float32 of the bf16 values).
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_raw[g][d] = __bfloat162float(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]);
  }
  if (append) {
    for (int d = tid; d < D; d += kThreads) {
      raw_s[0][d] = __bfloat162float(new_k[(static_cast<size_t>(b) * Hk + kvh) * D + d]);
      raw_s[1][d] = __bfloat162float(new_v[(static_cast<size_t>(b) * Hk + kvh) * D + d]);
    }
  }
  __syncthreads();

  // 2. Rotary, quantize and append of the new token; fold scale·k_descale
  //    into q and round it to bf16.
  const float qmul = __fmul_rn(scale, ks);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float x = rope ? rope_at<D>(q_raw[g], d, cb, sb) : q_raw[g][d];
    q_s[g][d] = round_bf16(__fmul_rn(x, qmul));
  }
  const int last = (append && length >= 1) ? length - 1 : -1;
  if (last >= 0) {
    for (int d = tid; d < D; d += kThreads) {
      const float kx = rope ? rope_at<D>(raw_s[0], d, cb, sb) : raw_s[0][d];
      store_code<KIND>(k_rows + static_cast<size_t>(last) * ROW, new_code[0], d, kx, ks);
      store_code<KIND>(v_rows + static_cast<size_t>(last) * ROW, new_code[1], d,
                       raw_s[1][d], vs);
    }
  }
  __syncthreads();

  // 3. Each warp: online softmax over key rows base+lane, base += 256. A
  //    lane loads its K and V rows together (16-byte loads, all in flight at
  //    once), scores its K row for every grouped q head, and stages its V row
  //    in shared memory, where the warp's PV sum reads it.
  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
  }
  const int lo = window > 0 ? max(0, length - window) : 0;
  for (int base = lo + warp * 32; base < length; base += kWarps * 32) {
    const int t = base + lane;
    float s[kMaxG];
    if (t < length) {
      const uint4* krow = reinterpret_cast<const uint4*>(
          t == last ? new_code[0] : k_rows + static_cast<size_t>(t) * ROW);
      const uint4* vrow = reinterpret_cast<const uint4*>(
          t == last ? new_code[1] : v_rows + static_cast<size_t>(t) * ROW);
      uint4 kr[ROW / 16], vr[ROW / 16];
#pragma unroll
      for (int c = 0; c < ROW / 16; ++c) {
        kr[c] = krow[c];
        vr[c] = vrow[c];
      }
#pragma unroll
      for (int c = 0; c < ROW / 16; ++c)
        reinterpret_cast<uint4*>(v_stage + lane * ROW)[c] = vr[c];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < ROW / 16; ++c) {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&kr[c]);
#pragma unroll
        for (int e = 0; e < 16 / ES; ++e) {
          const int d = c * (16 / ES) + e;
          const float kd = load_code<KIND>(bytes, e);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) s[g] = fmaf(q_s[g][d], kd, s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (softcap > 0.0f) s[g] = softcap * tanhf(s[g] / softcap);
    } else {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = -INFINITY;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float m_new = fmaxf(m[g], warp_max(s[g]));
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s[g] - m_new);
      l[g] = alpha * l[g] + warp_sum(p);
      p_s[warp][g][lane] = round_bf16(p);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
      m[g] = m_new;
    }
    __syncwarp();
    const int n = min(32, length - base);
    for (int jj = 0; jj < n; ++jj) {
      const uint8_t* row = v_stage + jj * ROW;
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vv[j] = load_code<KIND>(row, lane * DPL + j);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float p = p_s[warp][g][jj];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(p, vv[j], acc[g][j]);
      }
    }
    __syncwarp();  // the next rows overwrite v_stage and p_s
  }

  // 4. Merge the warps' partial softmaxes; V descale in the epilogue.
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc_w[warp][g][lane * DPL + j] = acc[g][j];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
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
    const float l_inv = Lsum == 0.0f ? 1.0f : vs / Lsum;
    out[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] = __float2bfloat16_rn(O * l_inv);
  }
}

template <int D>
void launch_kind(int kind, dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
                 uint8_t* ka, uint8_t* va, const int* lengths, int layer,
                 const __nv_bfloat16* nk, const __nv_bfloat16* nv, const float* cos,
                 const float* sin, const float* ks, const float* vs, __nv_bfloat16* out,
                 int B, int Hq, int Hk, int S, float scale, int window, float softcap) {
#define K2_LAUNCH(KIND)                                                          \
  do {                                                                           \
    constexpr int bytes = kWarps * 32 * D * (KIND == kCodeBF16 ? 2 : 1);         \
    cudaFuncSetAttribute(decode_arena_kernel<D, KIND>,                           \
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);    \
    decode_arena_kernel<D, KIND><<<grid, kThreads, bytes, s>>>(                  \
        q, ka, va, lengths, layer, nk, nv, cos, sin, ks, vs, out, B, Hq, Hk, S,  \
        scale, window, softcap);                                                 \
  } while (0)
  switch (kind) {
    case kCodeE4M3: K2_LAUNCH(kCodeE4M3); break;
    case kCodeE5M2: K2_LAUNCH(kCodeE5M2); break;
    case kCodeInt8: K2_LAUNCH(kCodeInt8); break;
    default: K2_LAUNCH(kCodeBF16); break;
  }
#undef K2_LAUNCH
}

}  // namespace

// new_k/new_v (and cos/sin) may be null: no append (no rotary). window <= 0
// and softcap <= 0 mean "off". D is 32, 64 or 128; Hq / Hk <= 8.
extern "C" int decode_arena_launch(const void* q, void* k_arena, void* v_arena,
                                   const void* lengths, int layer, const void* new_k,
                                   const void* new_v, const void* cos, const void* sin,
                                   const void* k_scale, const void* v_scale, void* out,
                                   int B, int Hq, int Hk, int S, int D, int kind,
                                   float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(Hk, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* ka = static_cast<uint8_t*>(k_arena);
  auto* va = static_cast<uint8_t*>(v_arena);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* nk = static_cast<const __nv_bfloat16*>(new_k);
  const auto* nv = static_cast<const __nv_bfloat16*>(new_v);
  const auto* cp = static_cast<const float*>(cos);
  const auto* sp = static_cast<const float*>(sin);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
    case 32:
      launch_kind<32>(kind, grid, s, qp, ka, va, lp, layer, nk, nv, cp, sp, ksp, vsp, op,
                      B, Hq, Hk, S, scale, window, softcap);
      break;
    case 64:
      launch_kind<64>(kind, grid, s, qp, ka, va, lp, layer, nk, nv, cp, sp, ksp, vsp, op,
                      B, Hq, Hk, S, scale, window, softcap);
      break;
    case 128:
      launch_kind<128>(kind, grid, s, qp, ka, va, lp, layer, nk, nv, cp, sp, ksp, vsp, op,
                       B, Hq, Hk, S, scale, window, softcap);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
