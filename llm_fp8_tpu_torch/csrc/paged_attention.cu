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
// 3.35 TB/s); the FLOPs are 2 per byte, far below the ridge. So the design
// is about keeping enough bytes in flight on every SM.
//
// Design: the sequence is split across blocks. The grid is (kv head,
// sequence, split); split z covers the keys of pages [z·pps, (z+1)·pps) of
// the sequence's table (pps and the split count come from the host, from
// the shapes alone: kernels/paged_attention.py::split_plan), so at the 1B
// decode shape 512 blocks of four warps fill the 132 SMs four deep, in one
// wave, where one block per (kv head, sequence) gave 64. Each warp walks 32-key groups; a lane
// copies its key's K and V rows (16-byte cp.async) into the warp's
// double-buffered stage while the warp scores the group before, then scores
// its key for all grouped q heads from the staged K row, and the warp's PV
// sum reads the staged V rows. Each warp keeps its own online softmax with p
// rounded to bf16 before the PV sum, as on the TPU; the block merges its
// warps and writes a float32 partial (max, sum, unnormalized out). A second
// kernel merges the partials of each (kv head, sequence) in split order and
// applies 1/sum and the V descale, so two runs are bit-identical (no float
// atomics). Only the split that holds position lengths-1 quantizes the new
// token exactly as the TPU kernel does (divide by kv_scale with __fdiv_rn,
// clip to ±fmax for the narrow kinds, round to nearest even) and stores its
// codes in the pool and in shared memory; the attention reads that position
// from the shared copy, so no thread reads back what another just wrote, and
// blocks of inactive slots that all append into the same scratch row never
// see each other's codes. q is multiplied by scale·kv_scale and rounded to
// bf16 once (the TPU kernel's folding). Keys outside the window are never
// read.
#include <math.h>

#include "fp8_ftz.cuh"

namespace {

constexpr int kWarps = 4, kThreads = kWarps * 32, kMaxG = 8;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_pages, uint8_t* v_pages,
                   const int* __restrict__ lengths, const int* __restrict__ tables,
                   const __nv_bfloat16* __restrict__ new_k,
                   const __nv_bfloat16* __restrict__ new_v, Partials part, int Hq,
                   PoolGeom geo, int pps, float qscale, float kv_scale, int window,
                   float softcap) {
  constexpr int ES = KIND == kCodeBF16 ? 2 : 1;  // bytes per stored element
  constexpr int ROW = D * ES;                      // bytes per token row
  constexpr int CH = ROW / 16;                     // 16-byte chunks per row
  constexpr int DPL = D / 32;                      // output dims per lane
  __shared__ __align__(16) float acc_w[kWarps][kMaxG][D];
  __shared__ __align__(16) float q_s[D][kMaxG];  // [d][g]: one dimension's heads together
  __shared__ __align__(16) uint8_t new_code[2][ROW];  // the appended K and V rows
  __shared__ float p_s[kWarps][kMaxG][32];
  __shared__ float m_w[kWarps][kMaxG], l_w[kWarps][kMaxG];
  // Dynamic shared memory: each warp's stage, [2 buffers][K, V][32 rows][ROW].
  extern __shared__ __align__(16) uint8_t stage_all[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  uint8_t* stage = stage_all + static_cast<size_t>(warp) * 2 * 2 * 32 * ROW;

  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z, S = gridDim.z;
  const int Hk = geo.Hk, G = Hq / Hk;
  const int length = max(0, min(lengths[b], geo.max_pages * geo.page));
  const int* table = tables + static_cast<size_t>(b) * geo.max_pages;
  const int span = pps * geo.page;  // keys per split

  // 1. Fold scale·kv_scale into q and round it to bf16; the split holding
  //    position lengths-1 quantizes and appends the new token there.
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float x = __bfloat162float(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]);
    q_s[d][g] = round_bf16(__fmul_rn(x, qscale));
  }
  const int last = (new_k != nullptr && length >= 1) ? length - 1 : -1;
  if (last >= 0 && last / span == z) {
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

  // 2. Each warp: online softmax over the 32-key groups base, base +
  //    kWarps·32, ... of this split's keys [lo, hi). A lane copies key
  //    base+lane's K and V rows into the stage (not the appended row, read
  //    from new_code) while the warp works on the group before.
  const int lo = max(z * span, window > 0 ? max(0, length - window) : 0);
  const int hi = min(length, (z + 1) * span);
  auto stage_k = [&](int buf) { return stage + (buf * 2 + 0) * 32 * ROW; };
  auto stage_v = [&](int buf) { return stage + (buf * 2 + 1) * 32 * ROW; };
  auto issue = [&](int base, int buf) {
    const int t = base + lane;
    if (t < hi && t != last) {
      const size_t off = geo.row_offset(table, t, kvh, ROW);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        cp_async16(stage_k(buf) + lane * ROW + c * 16, k_pages + off + c * 16);
        cp_async16(stage_v(buf) + lane * ROW + c * 16, v_pages + off + c * 16);
      }
    }
    cp_async_commit();
  };

  float m[kMaxG], l[kMaxG], acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
  }
  const int first = lo + warp * 32, step = kWarps * 32;
  if (first < hi) issue(first, 0);
  int buf = 0;
  for (int base = first; base < hi; base += step, buf ^= 1) {
    if (base + step < hi) issue(base + step, buf ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const int t = base + lane;
    float s[kMaxG];
    if (t < hi) {
      const uint4* krow = reinterpret_cast<const uint4*>(
          t == last ? new_code[0] : stage_k(buf) + lane * ROW);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint4 kc = krow[c];
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&kc);
#pragma unroll
        for (int e = 0; e < 16 / ES; ++e) {
          const int d = c * (16 / ES) + e;
          const float kd = load_code<KIND>(bytes, e);
          const float4 qa = *reinterpret_cast<const float4*>(&q_s[d][0]);
          s[0] = fmaf(qa.x, kd, s[0]);
          s[1] = fmaf(qa.y, kd, s[1]);
          s[2] = fmaf(qa.z, kd, s[2]);
          s[3] = fmaf(qa.w, kd, s[3]);
          if (G > 4) {
            const float4 qb = *reinterpret_cast<const float4*>(&q_s[d][4]);
            s[4] = fmaf(qb.x, kd, s[4]);
            s[5] = fmaf(qb.y, kd, s[5]);
            s[6] = fmaf(qb.z, kd, s[6]);
            s[7] = fmaf(qb.w, kd, s[7]);
          }
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
    const int n = min(32, hi - base);
    for (int jj = 0; jj < n; ++jj) {
      const uint8_t* row = base + jj == last ? new_code[1] : stage_v(buf) + jj * ROW;
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
    __syncwarp();  // the group after next overwrites this buffer and p_s
  }
  cp_async_wait<0>();

  // 3. Merge the warps' partial softmaxes (in warp order) into this split's
  //    partial; a split without live keys writes max -inf, sum 0, out 0.
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
  const size_t row0 = ((static_cast<size_t>(b) * Hk + kvh) * S + z) * G;
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
    part.o[(row0 + g) * D + d] = O;
    if (d == 0) {
      part.m[row0 + g] = M;
      part.l[row0 + g] = Lsum;
    }
  }
}

// Merges the splits of one (kv head, sequence) in split order: out = Σ o·f
// · (1/Σ l·f · kv_scale), f = exp(m - max m); 0 where no key was live (a
// zero-length sequence).
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(Partials part, __nv_bfloat16* __restrict__ out, int Hq, int Hk, int S,
                     float kv_scale) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = Hq / Hk;
  const size_t base = (static_cast<size_t>(b) * Hk + kvh) * S;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int z = 0; z < S; ++z) M = fmaxf(M, part.m[(base + z) * G + g]);
    float Lsum = 0.0f, O = 0.0f;
    if (M != -INFINITY) {
      for (int z = 0; z < S; ++z) {
        const size_t r = (base + z) * G + g;
        const float f = expf(part.m[r] - M);
        Lsum += part.l[r] * f;
        O += part.o[r * D + d] * f;
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
                const __nv_bfloat16* nv, Partials part, __nv_bfloat16* out, int Hq,
                PoolGeom geo, int pps, float qscale, float kv_scale, int window,
                float softcap) {
  cudaError_t e = cudaSuccess;
#define K5_LAUNCH(KIND)                                                              \
  do {                                                                               \
    constexpr int bytes = kWarps * 2 * 2 * 32 * D * (KIND == kCodeBF16 ? 2 : 1);     \
    e = cudaFuncSetAttribute(paged_split_kernel<D, KIND>,                            \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);    \
    if (e != cudaSuccess) return static_cast<int>(e);                                \
    paged_split_kernel<D, KIND><<<grid, kThreads, bytes, s>>>(                       \
        q, kp, vp, lengths, tables, nk, nv, part, Hq, geo, pps, qscale, kv_scale,    \
        window, softcap);                                                            \
  } while (0)
  switch (kind) {
    case kCodeE4M3: K5_LAUNCH(kCodeE4M3); break;
    case kCodeE5M2: K5_LAUNCH(kCodeE5M2); break;
    case kCodeInt8: K5_LAUNCH(kCodeInt8); break;
    case kCodeBF16: K5_LAUNCH(kCodeBF16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_LAUNCH
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_combine_kernel<D><<<dim3(grid.x, grid.y), kThreads, 0, s>>>(part, out, Hq, geo.Hk,
                                                                    grid.z, kv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// new_k/new_v may be null: no append. qscale = scale·kv_scale (folded into q
// on the host, as the TPU kernel folds it). window <= 0 and softcap <= 0 mean
// "off". D is 32, 64 or 128; Hq / Hk <= 8; the pools are [P, L, Hk, page, D].
// The sequence is cut into `splits` runs of `pps` pages; part_m and part_l
// hold B·Hk·splits·(Hq/Hk) floats, part_o that times D.
extern "C" int paged_attn_launch(const void* q, void* k_pages, void* v_pages,
                                 const void* lengths, const void* tables, const void* new_k,
                                 const void* new_v, void* out, void* part_m, void* part_l,
                                 void* part_o, int B, int Hq, int Hk, int D, int P, int L,
                                 int page, int max_pages, int layer, int kind, int splits,
                                 int pps, float qscale, float kv_scale, int window,
                                 float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  dim3 grid(Hk, B, splits);
  const PoolGeom geo{P, L, Hk, page, max_pages, layer};
  const Partials part{static_cast<float*>(part_m), static_cast<float*>(part_l),
                      static_cast<float*>(part_o)};
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
      return launch_kind<32>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, part, op, Hq, geo, pps,
                             qscale, kv_scale, window, softcap);
    case 64:
      return launch_kind<64>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, part, op, Hq, geo, pps,
                             qscale, kv_scale, window, softcap);
    case 128:
      return launch_kind<128>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, part, op, Hq, geo,
                              pps, qscale, kv_scale, window, softcap);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
