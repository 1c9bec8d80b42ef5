// K5: single-token decode attention over the paged KV pool, reached through
// block tables, with the new token's quantize and append done in the kernel.
//
// Replaces llm_fp8_tpu/kernels/paged_attention.py::paged_attention (Pallas
// _kernel). Features: append of the new K/V token at lengths-1 of each
// sequence, one kv_scale for K and V, GQA (up to 8 q heads per kv head),
// sliding window, softcap and ALiBi (slope·(t - (len - 1)) per q head, after
// softcap), over e4m3, e5m2, int8 and bf16 pools.
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
// wave, where one block per (kv head, sequence) gave 64. The walk over a
// split's keys and the merge of the splits are shared with K2
// (csrc/decode_split.cuh, which describes them); here a key's row is
// reached through the block table. Only the split that holds position
// lengths-1 quantizes the new token exactly as the TPU kernel does (divide
// by kv_scale with __fdiv_rn, clip to ±fmax for the narrow kinds, round to
// nearest even) and stores its codes in the pool and in shared memory;
// blocks of inactive slots that all append into the same scratch row never
// see each other's codes. q is multiplied by scale·kv_scale and rounded to
// bf16 once (the TPU kernel's folding). Keys outside the window are never
// read.
#include "decode_split.cuh"

namespace {

using namespace decode_split;

struct PoolGeom {
  int P, L, Hk, page, max_pages, layer;
};

// Byte offset of token t's row for one (kv head, sequence) through its
// table row.
struct PageRows {
  PoolGeom geo;
  const int* table;
  int kvh, row_bytes;
  __device__ __forceinline__ size_t operator()(int t) const {
    const int idx = min(t / geo.page, geo.max_pages - 1);
    const int pid = min(max(table[idx], 0), geo.P - 1);
    return ((((static_cast<size_t>(pid) * geo.L + geo.layer) * geo.Hk + kvh) * geo.page) +
            t % geo.page) *
           static_cast<size_t>(row_bytes);
  }
};

template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_pages, uint8_t* v_pages,
                   const int* __restrict__ lengths, const int* __restrict__ tables,
                   const __nv_bfloat16* __restrict__ new_k,
                   const __nv_bfloat16* __restrict__ new_v, const float* __restrict__ alibi,
                   Partials part, int Hq, PoolGeom geo, int pps, float qscale, float kv_scale,
                   int window, float softcap) {
  using W = Walk<D, KIND, PageRows>;
  __shared__ __align__(16) __nv_bfloat16 q_b[kMaxG][D];  // q folded, bf16; zero past G
  __shared__ __align__(16) uint8_t new_code[2][W::ROW];  // the appended K and V rows
  extern __shared__ __align__(16) uint8_t stage_all[];
  const int tid = threadIdx.x;
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z, splits = gridDim.z;
  const int Hk = geo.Hk, G = Hq / Hk;
  const int length = max(0, min(lengths[b], geo.max_pages * geo.page));
  const int* table = tables + static_cast<size_t>(b) * geo.max_pages;
  const int span = pps * geo.page;  // keys per split
  const int lo = max(z * span, window > 0 ? max(0, length - window) : 0);
  const int hi = min(length, (z + 1) * span);
  const int last = (new_k != nullptr && length >= 1) ? length - 1 : -1;
  const size_t row0 = ((static_cast<size_t>(b) * Hk + kvh) * splits + z) * G;
  if (lo >= hi) {  // never the split that appends: it holds lengths-1
    empty_partial(part, row0, G);
    return;
  }
  const PageRows rows{geo, table, kvh, W::ROW};
  const W walk(k_pages, v_pages, rows, lo, hi, last, stage_all);
  walk.prefetch();

  // Fold scale·kv_scale into q and round it to bf16; the split holding
  // position lengths-1 quantizes and appends the new token there.
  for (int i = tid; i < kMaxG * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float x = 0.0f;
    if (g < G)
      x = __fmul_rn(__bfloat162float(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]),
                    qscale);
    q_b[g][d] = __float2bfloat16_rn(x);
  }
  if (last >= 0 && last / span == z) {
    const size_t off = rows(last);
    const size_t src = (static_cast<size_t>(b) * Hk + kvh) * D;
    for (int d = tid; d < D; d += kThreads) {
      store_code<KIND>(k_pages + off, new_code[0], d, __bfloat162float(new_k[src + d]),
                       kv_scale);
      store_code<KIND>(v_pages + off, new_code[1], d, __bfloat162float(new_v[src + d]),
                       kv_scale);
    }
  }
  __syncthreads();
  walk.attend(q_b, new_code, G, softcap, alibi != nullptr ? alibi + kvh * G : nullptr,
              length - 1, part, row0);
}

template <int D>
int launch_kind(int kind, dim3 grid, cudaStream_t s, const __nv_bfloat16* q, uint8_t* kp,
                uint8_t* vp, const int* lengths, const int* tables, const __nv_bfloat16* nk,
                const __nv_bfloat16* nv, const float* alibi, Partials part,
                __nv_bfloat16* out, int Hq, PoolGeom geo, int pps, float qscale,
                float kv_scale, int window, float softcap) {
  // The stage's shared-memory limit is set once per kernel instance (a
  // function-local static), not on every launch of the decode step.
#define K5_LAUNCH(KIND)                                                              \
  do {                                                                               \
    constexpr int bytes = stage_bytes<D, KIND>();                                    \
    static const cudaError_t attr = cudaFuncSetAttribute(                            \
        paged_split_kernel<D, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
        bytes);                                                                      \
    if (attr != cudaSuccess) return static_cast<int>(attr);                          \
    paged_split_kernel<D, KIND><<<grid, kThreads, bytes, s>>>(                       \
        q, kp, vp, lengths, tables, nk, nv, alibi, part, Hq, geo, pps, qscale,       \
        kv_scale, window, softcap);                                                  \
  } while (0)
  switch (kind) {
    case kCodeE4M3: K5_LAUNCH(kCodeE4M3); break;
    case kCodeE5M2: K5_LAUNCH(kCodeE5M2); break;
    case kCodeInt8: K5_LAUNCH(kCodeInt8); break;
    case kCodeBF16: K5_LAUNCH(kCodeBF16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_LAUNCH
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = Hq / geo.Hk;  // the merge runs one thread per output
  combine_kernel<D><<<dim3(grid.x, grid.y), G * D, combine_bytes(grid.z, G), s>>>(
      part, out, Hq, geo.Hk, grid.z, nullptr, kv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// new_k/new_v may be null: no append; alibi ([Hq] float32 slopes) may be null:
// no bias. qscale = scale·kv_scale (folded into q
// on the host, as the TPU kernel folds it). window <= 0 and softcap <= 0 mean
// "off". D is 32, 64 or 128; Hq / Hk <= 8; the pools are [P, L, Hk, page, D].
// The sequence is cut into `splits` runs of `pps` pages; part_m and part_l
// hold B·Hk·splits·(Hq/Hk) floats, part_o that times D.
extern "C" int paged_attn_launch(const void* q, void* k_pages, void* v_pages,
                                 const void* lengths, const void* tables, const void* new_k,
                                 const void* new_v, const void* alibi, void* out, void* part_m,
                                 void* part_l,
                                 void* part_o, int B, int Hq, int Hk, int D, int P, int L,
                                 int page, int max_pages, int layer, int kind, int splits,
                                 int pps, float qscale, float kv_scale, int window,
                                 float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (splits <= 0 || Hk <= 0 || Hq % Hk || Hq / Hk > kMaxG ||
      combine_bytes(splits, Hq / Hk) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const auto* ap = static_cast<const float*>(alibi);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
    case 32:
      return launch_kind<32>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, ap, part, op, Hq, geo,
                             pps, qscale, kv_scale, window, softcap);
    case 64:
      return launch_kind<64>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, ap, part, op, Hq, geo,
                             pps, qscale, kv_scale, window, softcap);
    case 128:
      return launch_kind<128>(kind, grid, s, qp, kp, vp, lp, tp, nk, nv, ap, part, op, Hq, geo,
                              pps, qscale, kv_scale, window, softcap);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
