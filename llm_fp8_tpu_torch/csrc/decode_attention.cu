// K2: single-token decode attention over the KV arena, with the new token's
// rotary, quantize and append done in the kernel.
//
// Replaces llm_fp8_tpu/kernels/decode_attention.py::decode_attention_arena
// (Pallas _kernel). Features: append of the new K/V token at lengths-1, in-
// kernel rotary of q and the new K, per-KV-head k/v descales, GQA (up to 8
// q heads per kv head), sliding window, softcap and ALiBi (slope·(t - (len -
// 1)) per q head, after softcap; ALiBi models append without rotary), over
// e4m3, e5m2, int8 and bf16 arenas. A zero-length sequence reads nothing,
// appends nothing and gives zeros.
//
// Layout: the arena is [L, B, Hk, S, D] here, not the TPU's lane-major
// [L, B, Hk, D, S]: each token's D codes are contiguous, so a lane reads a
// whole key row with 16-byte copies. The TPU kernel's 128-lane tile
// read-modify-write of the append was an artifact of that layout; here the
// block that holds position lengths-1 writes the one token.
//
// Bound on the H100: the arena bytes, 2·len·Hk·D per sequence and layer (at
// B 8, Hk 8, D 64 and the lengths 1..1024 of chip_smoke.py's serve case, 4.0
// MB of e4m3 codes → 1.2 µs at 3.35 TB/s); the FLOPs are 2 per byte, far
// below the ridge. At that size the kernel is set by latency: how many
// blocks share the keys, and how many round trips to device memory each
// takes.
//
// Design: the sequence is split across blocks, as K5 is. The grid is (kv
// head, sequence, split); split z covers the arena rows [z·span,
// (z+1)·span), span a multiple of 32 keys (kernels/decode_attention.py::
// split_plan, from the shapes alone: no length is read on the host, so a
// CUDA graph can capture the call). At B 8 × Hk 8 × S 1024 that is 8 splits
// of 128 keys, 512 blocks of four warps: one wave on the 132 SMs at four
// blocks each, where the one block per (kv head, sequence) of the first
// port gave 64 blocks and walked the longest sequence's 1024 keys serially
// (41.1 µs). A split past lengths, or wholly before the window, writes an
// empty partial and returns. The walk (cp.async double-buffered 32-key
// groups per warp, first group issued before q is folded) and the fixed-
// order merge are shared with K5 in csrc/decode_split.cuh.
//
// Every split rotates q itself (the same bf16 q in each), multiplies it by
// scale·k_descale and rounds it to bf16 once (the TPU kernel's folding); the
// V descale is applied in the merge. Only the split that holds lengths-1
// rotates the new K (rope_at: no fused multiply-add, so the codes match the
// plain version bit for bit), divides by the head's descale (__fdiv_rn),
// clips, rounds to nearest even and stores the codes in the arena and in
// shared memory, where its walk reads them; no block reads back what
// another wrote.
//
// q·k and P·V run on mma.sync bf16 tiles (decode_split.cuh): the grouped q
// heads are the 8 columns of an m16n8k16 tile, the keys or dims its rows.
//
// Tried and dropped on the H100: the split with both products on CUDA
// cores (a lane scoring its key for every head, then 32 keys of p·v a
// lane), where the walk of one 32-key group a warp took most of the call;
// a merge of 128 threads with two outputs each, which waited on memory
// once more than one thread an output does.
#include "decode_split.cuh"

namespace {

using namespace decode_split;

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

// Byte offset of key t's row within one (kv head, sequence)'s arena rows.
struct ArenaRows {
  int row_bytes;
  __device__ __forceinline__ size_t operator()(int t) const {
    return static_cast<size_t>(t) * row_bytes;
  }
};

template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
decode_arena_split_kernel(const __nv_bfloat16* __restrict__ q, uint8_t* k_arena,
                          uint8_t* v_arena, const int* __restrict__ lengths, int layer,
                          const __nv_bfloat16* __restrict__ new_k,
                          const __nv_bfloat16* __restrict__ new_v,
                          const float* __restrict__ cos, const float* __restrict__ sin,
                          const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                          const float* __restrict__ alibi, Partials part, int B, int Hq, int Hk,
                          int S, int span, float scale, int window, float softcap) {
  using W = Walk<D, KIND, ArenaRows>;
  __shared__ float q_raw[kMaxG][D];
  __shared__ float raw_s[2][D];
  __shared__ __align__(16) __nv_bfloat16 q_b[kMaxG][D];  // q folded, bf16; zero past G
  __shared__ __align__(16) uint8_t new_code[2][W::ROW];  // the appended K and V rows
  extern __shared__ __align__(16) uint8_t stage_all[];
  const int tid = threadIdx.x;
  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z, splits = gridDim.z;
  const int G = Hq / Hk;
  const int length = max(0, min(lengths[b], S));
  const int lo = max(z * span, window > 0 ? max(0, length - window) : 0);
  const int hi = min(length, (z + 1) * span);
  const int last = (new_k != nullptr && length >= 1) ? length - 1 : -1;
  const size_t row0 = ((static_cast<size_t>(b) * Hk + kvh) * splits + z) * G;
  if (lo >= hi) {  // never the split that appends: it holds lengths-1
    empty_partial(part, row0, G);
    return;
  }
  const size_t head = ((static_cast<size_t>(layer) * B + b) * Hk + kvh) * S;
  uint8_t* k_rows = k_arena + head * W::ROW;
  uint8_t* v_rows = v_arena + head * W::ROW;
  const W walk(k_rows, v_rows, ArenaRows{W::ROW}, lo, hi, last, stage_all);
  walk.prefetch();

  const bool appends = last >= 0 && last / span == z, rope = cos != nullptr;
  const float* cb = rope ? cos + static_cast<size_t>(b) * (D / 2) : nullptr;
  const float* sb = rope ? sin + static_cast<size_t>(b) * (D / 2) : nullptr;
  const float ks = k_scale[kvh];

  // 1. Raw inputs into shared memory (float32 of the bf16 values).
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_raw[g][d] = __bfloat162float(q[(static_cast<size_t>(b) * Hq + kvh * G + g) * D + d]);
  }
  if (appends) {
    for (int d = tid; d < D; d += kThreads) {
      raw_s[0][d] = __bfloat162float(new_k[(static_cast<size_t>(b) * Hk + kvh) * D + d]);
      raw_s[1][d] = __bfloat162float(new_v[(static_cast<size_t>(b) * Hk + kvh) * D + d]);
    }
  }
  __syncthreads();

  // 2. Rotary of q, scale·k_descale folded in and rounded to bf16; the split
  //    holding lengths-1 rotates, quantizes and appends the new token.
  const float qmul = __fmul_rn(scale, ks);
  for (int i = tid; i < kMaxG * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float x = 0.0f;
    if (g < G) x = __fmul_rn(rope ? rope_at<D>(q_raw[g], d, cb, sb) : q_raw[g][d], qmul);
    q_b[g][d] = __float2bfloat16_rn(x);
  }
  if (appends) {
    const float vs = v_scale[kvh];
    for (int d = tid; d < D; d += kThreads) {
      const float kx = rope ? rope_at<D>(raw_s[0], d, cb, sb) : raw_s[0][d];
      store_code<KIND>(k_rows + static_cast<size_t>(last) * W::ROW, new_code[0], d, kx, ks);
      store_code<KIND>(v_rows + static_cast<size_t>(last) * W::ROW, new_code[1], d,
                       raw_s[1][d], vs);
    }
  }
  __syncthreads();

  // 3. The walk over [lo, hi) and this split's partial.
  walk.attend(q_b, new_code, G, softcap, alibi != nullptr ? alibi + kvh * G : nullptr,
              length - 1, part, row0);
}

template <int D>
int launch_kind(int kind, dim3 grid, cudaStream_t s, const __nv_bfloat16* q, uint8_t* ka,
                uint8_t* va, const int* lengths, int layer, const __nv_bfloat16* nk,
                const __nv_bfloat16* nv, const float* cos, const float* sin, const float* ks,
                const float* vs, const float* alibi, Partials part, __nv_bfloat16* out, int B,
                int Hq, int Hk, int S, int span, float scale, int window, float softcap) {
  // The stage's shared-memory limit is set once per kernel instance (a
  // function-local static), not on every launch of the decode step.
#define K2_LAUNCH(KIND)                                                               \
  do {                                                                                \
    constexpr int bytes = stage_bytes<D, KIND>();                                     \
    static const cudaError_t attr = cudaFuncSetAttribute(                             \
        decode_arena_split_kernel<D, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        bytes);                                                                       \
    if (attr != cudaSuccess) return static_cast<int>(attr);                           \
    decode_arena_split_kernel<D, KIND><<<grid, kThreads, bytes, s>>>(                 \
        q, ka, va, lengths, layer, nk, nv, cos, sin, ks, vs, alibi, part, B, Hq, Hk, S, \
        span, scale, window, softcap);                                                \
  } while (0)
  switch (kind) {
    case kCodeE4M3: K2_LAUNCH(kCodeE4M3); break;
    case kCodeE5M2: K2_LAUNCH(kCodeE5M2); break;
    case kCodeInt8: K2_LAUNCH(kCodeInt8); break;
    case kCodeBF16: K2_LAUNCH(kCodeBF16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K2_LAUNCH
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int G = Hq / Hk;  // the merge runs one thread per output
  combine_kernel<D><<<dim3(grid.x, grid.y), G * D, combine_bytes(grid.z, G), s>>>(
      part, out, Hq, Hk, grid.z, vs, 1.0f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// new_k/new_v (and cos/sin) may be null: no append (no rotary). alibi
// ([Hq] float32 slopes) may be null: no bias. window <= 0 and softcap <= 0
// mean "off". D is 32, 64 or 128; Hq / Hk <= 8. The arena
// rows are cut into `splits` runs of `span` keys (span a multiple of 32);
// part_m and part_l hold B·Hk·splits·(Hq/Hk) floats, part_o that times D.
extern "C" int decode_arena_launch(const void* q, void* k_arena, void* v_arena,
                                   const void* lengths, int layer, const void* new_k,
                                   const void* new_v, const void* cos, const void* sin,
                                   const void* k_scale, const void* v_scale, const void* alibi,
                                   void* out,
                                   void* part_m, void* part_l, void* part_o, int B, int Hq,
                                   int Hk, int S, int D, int kind, int splits, int span,
                                   float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (splits <= 0 || span <= 0 || span % 32 || static_cast<long long>(splits) * span < S ||
      Hk <= 0 || Hq % Hk || Hq / Hk > kMaxG || combine_bytes(splits, Hq / Hk) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Hk, B, splits);
  const Partials part{static_cast<float*>(part_m), static_cast<float*>(part_l),
                      static_cast<float*>(part_o)};
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
  const auto* ap = static_cast<const float*>(alibi);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (D) {
    case 32:
      return launch_kind<32>(kind, grid, s, qp, ka, va, lp, layer, nk, nv, cp, sp, ksp, vsp,
                             ap, part, op, B, Hq, Hk, S, span, scale, window, softcap);
    case 64:
      return launch_kind<64>(kind, grid, s, qp, ka, va, lp, layer, nk, nv, cp, sp, ksp, vsp,
                             ap, part, op, B, Hq, Hk, S, span, scale, window, softcap);
    case 128:
      return launch_kind<128>(kind, grid, s, qp, ka, va, lp, layer, nk, nv, cp, sp, ksp, vsp,
                             ap, part, op, B, Hq, Hk, S, span, scale, window, softcap);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
