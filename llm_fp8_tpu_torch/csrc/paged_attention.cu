// K5: single-token decode attention over the paged KV pool, reached through
// block tables, with the new token's quantize and append done in the kernel.
//
// Replaces llm_fp8_tpu/kernels/paged_attention.py::paged_attention (Pallas
// _kernel). Features: append of the new K/V token at lengths-1 of each
// sequence, one kv_scale for K and V, GQA (up to 8 q heads per kv head),
// sliding window and softcap, over e4m3, e5m2, int8 and bf16 pools. ALiBi is
// not ported (the wrapper raises).
//
// Layout: the pools are [P, L, Hk, page, D] here, not the TPU's lane-major
// [P, L, Hk, D, page]: a token's D codes are contiguous, so a lane reads a
// whole key row with 16-byte loads. Token t of sequence b lives in physical
// page tables[b][t / page] (clamped to [0, P-1], as the TPU kernel clamps, so
// a table padded with -1 or any other id never reads outside the pool) at
// row t % page.
//
// Bound on the H100: the pool bytes a step reads, 2·len·Hk·D per sequence
// and layer (at B 8, Hk 8, D 64 and len 8192 in fp8: 67 MB → 20 µs at
// 3.35 TB/s); the FLOPs are 2 per byte, far below the ridge.
//
// Design: one block of eight warps per (kv head, sequence), as K2. The block
// quantizes the new token exactly as the TPU kernel does (divide by kv_scale
// with __fdiv_rn, clip to ±fmax for the narrow kinds, round to nearest even)
// and stores its codes in the pool and in shared memory; the attention reads
// position lengths-1 from the shared copy, so no thread reads back what
// another just wrote, and blocks of inactive slots that all append into the
// same scratch row never see each other's codes. q is multiplied by
// scale·kv_scale and rounded to bf16 once (the TPU kernel's folding); the V
// descale is applied in the epilogue. Each lane looks up its key row's page,
// loads the K and V rows together, scores the key for all grouped q heads
// and stages the V row in shared memory for the warp's PV sum. Each warp keeps
// its own online softmax with p rounded to bf16 before the PV sum, as on the
// TPU, and the warps' partial results are merged at the end. Keys outside
// the window are never read. At the 1B decode shape only 64 blocks run
// (B 8 × Hk 8 on 132 SMs); splitting the sequence across blocks is later work.
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

template <int KIND>
__device__ __forceinline__ float load_code(const uint8_t* row, int d) {
  if constexpr (KIND == kCodeBF16)
    return bf16_bits_to_float(reinterpret_cast<const uint16_t*>(row)[d]);
  else
    return code_to_float<KIND>(row[d]);
}

// Quantizes one new-token element: writes its code to the pool row and to
// `copy` (a shared-memory row the attention reads in its place).
template <int KIND>
__device__ __forceinline__ void store_code(uint8_t* row, uint8_t* copy, int d, float x,
                                           float kv_scale) {
  if constexpr (KIND == kCodeBF16) {
    const __nv_bfloat16 h = __float2bfloat16_rn(__fdiv_rn(x, kv_scale));
    reinterpret_cast<__nv_bfloat16*>(row)[d] = h;
    reinterpret_cast<__nv_bfloat16*>(copy)[d] = h;
  } else {
    const float fmax = kind_max<KIND>();
    const uint8_t c = float_to_code<KIND>(fminf(fmaxf(__fdiv_rn(x, kv_scale), -fmax), fmax));
    row[d] = c;
    copy[d] = c;
  }
}

struct PoolGeom {
  int P, L, Hk, page, max_pages, layer;
  // Byte offset of token t's row for (kv head kvh) through the table row.
  __device__ __forceinline__ size_t row_offset(const int* table, int t, int kvh,
                                               int row_bytes) const {
    const int idx = min(t / page, max_pages - 1);
    const int pid = min(max(table[idx], 0), P - 1);
    return ((((static_cast<size_t>(pid) * L + layer) * Hk + kvh) * page) + t % page) *
           static_cast<size_t>(row_bytes);
  }
};

template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_pages, uint8_t* v_pages,
                  const int* __restrict__ lengths, const int* __restrict__ tables,
                  const __nv_bfloat16* __restrict__ new_k,
                  const __nv_bfloat16* __restrict__ new_v, __nv_bfloat16* __restrict__ out,
                  int Hq, PoolGeom geo, float qscale, float kv_scale, int window,
                  float softcap) {
  constexpr int ES = KIND == kCodeBF16 ? 2 : 1;  // bytes per stored element
  constexpr int ROW = D * ES;                      // bytes per token row
  constexpr int DPL = D / 32;                      // output dims per lane
  // `big` holds the warps' partial outputs at the end (D = 128 would not
  // fit the 48 KB of static shared memory twice).
  __shared__ __align__(16) float big[kWarps * kMaxG * D];
  __shared__ float q_s[kMaxG][D];
  __shared__ __align__(16) uint8_t new_code[2][ROW];  // the appended K and V rows
  __shared__ float p_s[kWarps][kMaxG][32];
  __shared__ float m_w[kWarps][kMaxG], l_w[kWarps][kMaxG];
  float (*acc_w)[kMaxG][D] = reinterpret_cast<float (*)[kMaxG][D]>(big);
  // Dynamic shared memory: each warp's 32 staged V rows.
  extern __shared__ __align__(16) uint8_t v_stage_all[];
  uint8_t* v_stage = v_stage_all + static_cast<size_t>(threadIdx.x / 32) * 32 * ROW;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int Hk = geo.Hk, G = Hq / Hk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int length = max(0, min(lengths[b], geo.max_pages * geo.page));
  const int* table = tables + static_cast<size_t>(b) * geo.max_pages;
  const bool append = new_k != nullptr;

  // 1. Fold scale·kv_scale into q and round it to bf16; quantize and append
  //    the new token at lengths-1.
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float x = __bfloat162float(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]);
    q_s[g][d] = round_bf16(__fmul_rn(x, qscale));
  }
  const int last = (append && length >= 1) ? length - 1 : -1;
  if (last >= 0) {
    const size_t off = geo.row_offset(table, last, kvh, ROW);
    const size_t src = (static_cast<size_t>(b) * Hk + kvh) * D;
    for (int d = tid; d < D; d += kThreads) {
      store_code<KIND>(k_pages + off, new_code[0], d, __bfloat162float(new_k[src + d]),
                       kv_scale);
      store_code<KIND>(v_pages + off, new_code[1], d, __bfloat162float(new_v[src + d]),
                       kv_scale);
    }
  }
  __syncthreads();

  // 2. Each warp: online softmax over key rows base+lane, base += 256. A
  //    lane finds its row's page, loads its K and V rows together (16-byte
  //    loads), scores its K row for every grouped q head, and stages its V
  //    row in shared memory, where the warp's PV sum reads it.
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
      const uint4* krow;
      const uint4* vrow;
      if (t == last) {
        krow = reinterpret_cast<const uint4*>(new_code[0]);
        vrow = reinterpret_cast<const uint4*>(new_code[1]);
      } else {
        const size_t off = geo.row_offset(table, t, kvh, ROW);
        krow = reinterpret_cast<const uint4*>(k_pages + off);
        vrow = reinterpret_cast<const uint4*>(v_pages + off);
      }
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

  // 3. Merge the warps' partial softmaxes; out = acc · (1/l · kv_scale), and
  //    0 where no key was live (a zero-length sequence).
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
    const float l_inv = Lsum == 0.0f ? 1.0f : 1.0f / Lsum;
    out[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d] =
        __float2bfloat16_rn(O * __fmul_rn(l_inv, kv_scale));
  }
}

template <int D>
int launch_kind(int kind, dim3 grid, cudaStream_t s, const __nv_bfloat16* q, uint8_t* kp,
                uint8_t* vp, const int* lengths, const int* tables, const __nv_bfloat16* nk,
                const __nv_bfloat16* nv, __nv_bfloat16* out, int Hq, PoolGeom geo,
                float qscale, float kv_scale, int window, float softcap) {
  cudaError_t e = cudaSuccess;
#define K5_LAUNCH(KIND)                                                            \
  do {                                                                             \
    constexpr int bytes = kWarps * 32 * D * (KIND == kCodeBF16 ? 2 : 1);           \
    e = cudaFuncSetAttribute(paged_attn_kernel<D, KIND>,                           \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);  \
    if (e != cudaSuccess) return static_cast<int>(e);                              \
    paged_attn_kernel<D, KIND><<<grid, kThreads, bytes, s>>>(                      \
        q, kp, vp, lengths, tables, nk, nv, out, Hq, geo, qscale, kv_scale, window, \
        softcap);                                                                  \
  } while (0)
  switch (kind) {
    case kCodeE4M3: K5_LAUNCH(kCodeE4M3); break;
    case kCodeE5M2: K5_LAUNCH(kCodeE5M2); break;
    case kCodeInt8: K5_LAUNCH(kCodeInt8); break;
    case kCodeBF16: K5_LAUNCH(kCodeBF16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// new_k/new_v may be null: no append. qscale = scale·kv_scale (folded into q
// on the host, as the TPU kernel folds it). window <= 0 and softcap <= 0 mean
// "off". D is 32, 64 or 128; Hq / Hk <= 8; the pools are [P, L, Hk, page, D].
extern "C" int paged_attn_launch(const void* q, void* k_pages, void* v_pages,
                                 const void* lengths, const void* tables, const void* new_k,
                                 const void* new_v, void* out, int B, int Hq, int Hk, int D,
                                 int P, int L, int page, int max_pages, int layer, int kind,
                                 float qscale, float kv_scale, int window, float softcap,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  dim3 grid(Hk, B);
  const PoolGeom geo{P, L, Hk, page, max_pages, layer};
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<uint8_t*>(k_pages);
  auto* vp = static_cast<uint8_t*>(v_pages);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* tp = static_cast<const int*>(tables);
  const auto* nk = static_cast<const __nv_bfloat16*>(new_k);
  const auto* nv = static_cast<const __nv_bfloat16*>(new_v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
    case 32:
      return launch_kind<32>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, op, Hq, geo, qscale,
                             kv_scale, window, softcap);
    case 64:
      return launch_kind<64>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, op, Hq, geo, qscale,
                             kv_scale, window, softcap);
    case 128:
      return launch_kind<128>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, op, Hq, geo, qscale,
                              kv_scale, window, softcap);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
