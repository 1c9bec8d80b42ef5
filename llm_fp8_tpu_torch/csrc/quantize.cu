// K9: per-row or per-column amax + quantize of a 2-D operand, each element
// read from device memory once.
//
// Replaces llm_fp8_tpu/kernels/quantize.py::quantize_fused (_kernel_rows,
// _kernel_cols). Input float32 or bf16 [M, N]; output codes (e4m3, e5m2 or
// int8) [M, N] and float32 scales, [M] for rows (amax over N) or [N] for
// columns (amax over M). The arithmetic is the plain version's
// (kernels/quantize.py::quantize_fused_plain) bit for bit:
//   scale = __fdiv_rn(max(amax, 1e-12), fmax) * 2^margin   (true division)
//   code  = cvt.rn.satfinite(clip(__fdiv_rn(x, scale)))     (rintf for int8)
// A max does not depend on the order of the reduction, so every route below
// gives the same codes and scales. A NaN propagates into the amax as in
// torch.amax; codes of non-finite inputs are not held to the plain version.
//
// Bound on the H100: bytes, one read of the input and a one-byte write per
// element. The training step's gradients are float32 [4096, N] (N = 3072,
// 2048, 16384, 2048: 335 MB at gate|up, 100 µs at 3.35 TB/s); the serving
// route quantizes each projection's bf16 input per row ([8192, 2048] at a
// prefill bucket: 50 MB, 15 µs; [8, 2048] at decode, where the kernel is a
// launch and one round trip).
//
// The first port read every element twice (a second pass for the codes,
// from L1/L2 at best) and stored codes one byte a lane; it reached 25%
// (columns) and 35% (rows) of the byte bound. Here every element is read
// once, with 16-byte loads wherever N·size and the pointers allow (a scalar
// edge otherwise: the same layout, element by element), and a lane stores
// the codes of one 16-byte input vector as one 4-byte (float32) or 8-byte
// (bf16) word, so a warp's stores fill whole 32-byte sectors. The route is
// chosen on the host from (M, N, dtype, axis) alone
// (kernels/quantize.py::route); the launcher checks that it fits the shape.
//
// Rows:
//   rows_regs  — the row in registers: W warps a row (1..16), each lane
//     holding V 16-byte vectors (at most 32 elements: V ≤ 8 float32, 4
//     bf16), 256-thread blocks of 8/W rows (one 512-thread block a row at
//     W = 16). The warps reduce the amax (a redux.sync, then shared memory
//     across the row's warps) and quantize what they hold. Up to N = 16384
//     (the training gradients: one block a row at gate|up; the serving
//     shapes: two warps a row at N = 2048, eight at 8192). A first form
//     with 64 bf16 elements a lane held too many registers for enough
//     warps in flight and ran at about twice the byte bound there.
//   rows_smem  — one 512-thread block a row, the row staged in dynamic
//     shared memory as it is read: N·size ≤ 192 KiB.
//   rows_stream — longer rows: the same block reads the row twice (amax,
//     then codes). A cluster exchanging the amax through distributed shared
//     memory would hold them in one read; no path of the port has such rows.
// Columns:
//   cols_cluster — a cluster of 8 blocks splits M for one 32-column strip
//     (a row's 32 codes fill a sector). Each block copies its [ceil(M/8),
//     32] slab into dynamic shared memory (16-byte cp.async, all in flight,
//     no registers held), takes its column maxima (shuffles, then across
//     warps), publishes them in shared memory, and after a
//     cluster barrier reads the other 7 blocks' maxima through distributed
//     shared memory (map_shared_rank) and quantizes its slab from shared
//     memory. At [4096, N] float32 a block holds a 64 KiB slab. Up to
//     ceil(M/8)·32·size ≤ 192 KiB: M ≤ 12288 float32, 24576 bf16.
//   cols_stream — taller columns: the same cluster, each block reading its
//     rows twice.
// Tried and dropped: the first port's 8-column strips (8-byte pieces of
// 32-byte sectors) and one 256-thread block a row (2-4 bytes a thread in
// flight).
#include <cooperative_groups.h>

#include "fp8_ftz.cuh"

namespace cg = cooperative_groups;

namespace {

// Route codes shared with kernels/quantize.py::ROUTES.
enum : int { kRowsRegs = 0, kRowsSmem = 1, kRowsStream = 2, kColsCluster = 3, kColsStream = 4 };

constexpr int kRowWarpsMax = 16, kLaneElems = 32;  // rows_regs: warps a row, elements a lane
constexpr int kRowBlock = 512;                      // rows_smem / rows_stream threads
constexpr int kCluster = 8, kStrip = 32, kColThreads = 256;
constexpr int kSmemMax = 192 * 1024;                // dynamic shared memory a block stages

__device__ __forceinline__ float scale_of(float amax, float fmax, float mult) {
  return __fmul_rn(__fdiv_rn(fmaxf(amax, 1e-12f), fmax), mult);
}

template <int KIND>
__device__ __forceinline__ uint32_t code_of(float x, float scale, float fmax) {
  return float_to_code<KIND>(fminf(fmaxf(__fdiv_rn(x, scale), -fmax), fmax));
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Element j of a 16-byte vector of T, as float.
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int j) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r, j));
  } else {
    const uint32_t w = word(r, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// The amax is taken on bit patterns: with the sign bit cleared, floats
// order as unsigned integers, and a NaN's pattern lies above +inf's, so the
// largest pattern is that of the largest |x|, or a NaN (torch.amax's NaN).
// A bf16 word holds two patterns, compared at once (__vmaxu2).
template <typename T>
__device__ __forceinline__ uint32_t abs_bits(uint32_t w) {
  return w & (sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu);
}

template <typename T>
__device__ __forceinline__ uint32_t max_bits(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 4) return max(a, b);
  else return __vmaxu2(a, b);
}

// The largest |x| pattern of a vector, folded into m (two halves for bf16).
template <typename T>
__device__ __forceinline__ uint32_t vec_max_bits(const uint4& r, uint32_t m) {
  const uint32_t a = max_bits<T>(abs_bits<T>(r.x), abs_bits<T>(r.y));
  const uint32_t b = max_bits<T>(abs_bits<T>(r.z), abs_bits<T>(r.w));
  return max_bits<T>(m, max_bits<T>(a, b));
}

// A folded pattern as the float32 pattern of its value (bf16: the larger
// half, widened).
template <typename T>
__device__ __forceinline__ uint32_t to_f32_bits(uint32_t m) {
  if constexpr (sizeof(T) == 4) return m;
  else return max(m & 0xffffu, m >> 16) << 16;
}

// The 16 bytes of row[e0 .. e0 + 16/sizeof(T)); elements at or past N read
// as 0. `vec`: one 16-byte load (N a multiple of the vector, row 16-byte
// aligned); else element by element.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* row, int e0, int N, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) return e0 < N ? __ldg(reinterpret_cast<const uint4*>(row + e0)) : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (e0 + j < N) {
      if constexpr (sizeof(T) == 4)
        w[j] = __float_as_uint(row[e0 + j]);
      else
        w[j >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(row[e0 + j])) << (16 * (j & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The codes of one vector, element j's scale s[j], packed 4 a word.
template <typename T, int KIND>
__device__ __forceinline__ void codes_of(const uint4& r, const float* s, float fmax,
                                         uint32_t (&c)[2]) {
  c[0] = c[1] = 0u;
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    c[j >> 2] |= code_of<KIND>(elem<T>(r, j), s[j], fmax) << (8 * (j & 3));
}

// Stores the codes of row[e0 ..]: one 4-byte (float32 input) or 8-byte
// (bf16) word, or byte by byte at a ragged or unaligned edge.
template <typename T>
__device__ __forceinline__ void store_codes(uint8_t* row, int e0, int N, bool vec,
                                            const uint32_t (&c)[2]) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    if (e0 >= N) return;
    if constexpr (V == 4) *reinterpret_cast<uint32_t*>(row + e0) = c[0];
    else *reinterpret_cast<uint2*>(row + e0) = make_uint2(c[0], c[1]);
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (e0 + j < N) row[e0 + j] = static_cast<uint8_t>(c[j >> 2] >> (8 * (j & 3)));
}

// Quantizes one vector with one scale for all its elements and stores it.
template <typename T, int KIND>
__device__ __forceinline__ void quantize_store(const uint4& r, float s, float fmax, uint8_t* row,
                                               int e0, int N, bool vec) {
  float sv[16 / sizeof(T)];
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) sv[j] = s;
  uint32_t c[2];
  codes_of<T, KIND>(r, sv, fmax, c);
  store_codes<T>(row, e0, N, vec, c);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows_regs: W warps a row, each lane V vectors of the row in registers.
template <typename T, int KIND, int V>
__global__ void __launch_bounds__(kRowWarpsMax * 32)
quantize_rows_regs(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scale,
                   int M, int N, int W, float fmax, float mult, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ uint32_t red[kRowWarpsMax];
  const int tpr = W * 32;  // threads a row
  const int grp = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + grp;
  const bool live = row < M;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * N;
  uint4 r[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    r[i] = live ? load_vec(xr, (i * tpr + t) * VEC, N, vec) : make_uint4(0, 0, 0, 0);
  uint32_t m = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i) m = vec_max_bits<T>(r[i], m);
  m = __reduce_max_sync(0xffffffffu, to_f32_bits<T>(m));
  if (W > 1) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
    __syncthreads();
    for (int w = 0; w < W; ++w) m = max(m, red[grp * W + w]);
  }
  if (!live) return;
  const float s = scale_of(__uint_as_float(m), fmax, mult);
  if (t == 0) scale[row] = s;
  uint8_t* qr = q + static_cast<size_t>(row) * N;
#pragma unroll
  for (int i = 0; i < V; ++i) quantize_store<T, KIND>(r[i], s, fmax, qr, (i * tpr + t) * VEC, N, vec);
}

// rows_smem (STAGED) and rows_stream: one block a row. STAGED keeps the
// vectors it reads in dynamic shared memory (each thread reads back only
// its own); otherwise the second pass reads the row again.
template <typename T, int KIND, bool STAGED>
__global__ void __launch_bounds__(kRowBlock)
quantize_rows_block(const T* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ scale, int N, float fmax, float mult, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ uint4 row_s[];
  __shared__ uint32_t red[kRowBlock / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * N;
  uint8_t* qr = q + row * N;
  const int nv = (N + VEC - 1) / VEC;
  uint32_t m = 0u;
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < nv; i += kRowBlock) {
      if (vec) cp_async16(&row_s[i], xr + i * VEC);
      else row_s[i] = load_vec(xr, i * VEC, N, false);
    }
    cp_async_wait_all();
    for (int i = threadIdx.x; i < nv; i += kRowBlock) m = vec_max_bits<T>(row_s[i], m);
  } else {
#pragma unroll 8
    for (int i = threadIdx.x; i < nv; i += kRowBlock) m = vec_max_bits<T>(load_vec(xr, i * VEC, N, vec), m);
  }
  m = __reduce_max_sync(0xffffffffu, to_f32_bits<T>(m));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kRowBlock / 32; ++w) m = max(m, red[w]);
  const float s = scale_of(__uint_as_float(m), fmax, mult);
  if (threadIdx.x == 0) scale[row] = s;
#pragma unroll 8
  for (int i = threadIdx.x; i < nv; i += kRowBlock) {
    const uint4 r = STAGED ? row_s[i] : load_vec(xr, i * VEC, N, vec);
    quantize_store<T, KIND>(r, s, fmax, qr, i * VEC, N, vec);
  }
}

// cols_cluster (STAGED) and cols_stream: a cluster of kCluster blocks
// splits M for one 32-column strip; the column maxima meet through
// distributed shared memory. A thread keeps one 16-byte column chunk c of
// the rows rr, rr + RSTEP, ...: the same chunks in both passes, so the
// STAGED slab needs no barrier between its copy and its reads.
template <typename T, int KIND, bool STAGED>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kColThreads)
quantize_cols(const T* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scale,
              int M, int N, float fmax, float mult, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = kStrip / VEC;            // chunks of a strip row
  constexpr int RSTEP = kColThreads / CPR;     // rows the block covers at once
  extern __shared__ uint4 slab[];              // STAGED: [rows][CPR]
  __shared__ uint32_t red[kColThreads / 32][kStrip];
  __shared__ uint32_t colmax[kStrip];
  __shared__ float s_col[kStrip];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = (M + kCluster - 1) / kCluster;
  const int r0 = rank * rows, nrows = max(0, min(M - r0, rows));
  const int c = threadIdx.x % CPR, rr = threadIdx.x / CPR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.y * kStrip + c * VEC;  // this thread's first column
  const T* xc = x + static_cast<size_t>(r0) * N;

  // Pass 1: the column maxima (STAGED: from the slab once it is copied).
  uint32_t acc[4] = {0u, 0u, 0u, 0u};  // per word of the chunk
  auto fold = [&](const uint4& v) {
    acc[0] = max_bits<T>(acc[0], abs_bits<T>(v.x));
    acc[1] = max_bits<T>(acc[1], abs_bits<T>(v.y));
    acc[2] = max_bits<T>(acc[2], abs_bits<T>(v.z));
    acc[3] = max_bits<T>(acc[3], abs_bits<T>(v.w));
  };
  if constexpr (STAGED) {
    for (int r = rr; r < nrows; r += RSTEP) {
      uint4* dst = &slab[r * CPR + c];
      if (vec && col0 < N) cp_async16(dst, xc + static_cast<size_t>(r) * N + col0);
      else *dst = load_vec(xc + static_cast<size_t>(r) * N, col0, N, vec);
    }
    cp_async_wait_all();
    for (int r = rr; r < nrows; r += RSTEP) fold(slab[r * CPR + c]);
  } else {
#pragma unroll 8
    for (int r = rr; r < nrows; r += RSTEP) fold(load_vec(xc + static_cast<size_t>(r) * N, col0, N, vec));
  }
  // Lanes 32/CPR apart hold the same chunk: fold them, then the warps.
#pragma unroll
  for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = max_bits<T>(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], o));
  if (lane < CPR) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t w = acc[sizeof(T) == 4 ? j : j >> 1];
      red[warp][c * VEC + j] = sizeof(T) == 4 ? w : ((w >> (16 * (j & 1))) & 0xffffu) << 16;
    }
  }
  __syncthreads();
  if (threadIdx.x < kStrip) {
    uint32_t mm = 0u;
#pragma unroll
    for (int w = 0; w < kColThreads / 32; ++w) mm = max(mm, red[w][threadIdx.x]);
    colmax[threadIdx.x] = mm;
  }
  cluster.sync();  // every block's maxima are published
  if (threadIdx.x < kStrip) {
    uint32_t mm = 0u;
#pragma unroll
    for (int b = 0; b < kCluster; ++b) mm = max(mm, *cluster.map_shared_rank(&colmax[threadIdx.x], b));
    const float s = scale_of(__uint_as_float(mm), fmax, mult);
    s_col[threadIdx.x] = s;
    const int col = blockIdx.y * kStrip + threadIdx.x;
    if (rank == 0 && col < N) scale[col] = s;
  }
  __syncthreads();

  // Pass 2: the codes, from the slab or from device memory again.
  float sv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sv[j] = s_col[c * VEC + j];
  uint8_t* qc = q + static_cast<size_t>(r0) * N;
#pragma unroll 4
  for (int r = rr; r < nrows; r += RSTEP) {
    const uint4 v = STAGED ? slab[r * CPR + c] : load_vec(xc + static_cast<size_t>(r) * N, col0, N, vec);
    uint32_t cw[2];
    codes_of<T, KIND>(v, sv, fmax, cw);
    store_codes<T>(qc + static_cast<size_t>(r) * N, col0, N, vec, cw);
  }
  cluster.sync();  // no block leaves while another may still read its maxima
}

// Sets a kernel's dynamic shared-memory limit once per instance (a
// function-local static), not on every launch.
template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <typename T, int KIND>
int launch(const void* x, void* q, void* scale, int M, int N, int route, int warps, int vecs,
           float fmax, float mult, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* sp = static_cast<float*>(scale);
  const bool vec = N % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % VEC == 0;
  const long long nv = (N + VEC - 1) / VEC;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  switch (route) {
    case kRowsRegs: {
      if (warps < 1 || warps > kRowWarpsMax || (warps & (warps - 1)) || vecs < 1 ||
          vecs * VEC > kLaneElems || (vecs & (vecs - 1)) || 32LL * warps * vecs < nv)
        return invalid;
      const int rpb = warps >= 8 ? 1 : 8 / warps;  // rows a block
      const dim3 grid((M + rpb - 1) / rpb), block(rpb * warps * 32);
#define K9_ROWS(V)                                                                            \
  quantize_rows_regs<T, KIND, V><<<grid, block, 0, st>>>(xp, qp, sp, M, N, warps, fmax, mult, \
                                                         vec)
      switch (vecs) {
        case 1: K9_ROWS(1); break;
        case 2: K9_ROWS(2); break;
        case 4: K9_ROWS(4); break;
        default:
          if constexpr (VEC * 8 <= kLaneElems) K9_ROWS(8);
          break;
      }
#undef K9_ROWS
      break;
    }
    case kRowsSmem: {
      const long long bytes = nv * 16;
      if (bytes > kSmemMax) return invalid;
      static const cudaError_t attr = allow_smem(quantize_rows_block<T, KIND, true>);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      quantize_rows_block<T, KIND, true><<<M, kRowBlock, bytes, st>>>(xp, qp, sp, N, fmax, mult,
                                                                     vec);
      break;
    }
    case kRowsStream:
      quantize_rows_block<T, KIND, false><<<M, kRowBlock, 0, st>>>(xp, qp, sp, N, fmax, mult,
                                                                  vec);
      break;
    case kColsCluster:
    case kColsStream: {
      const long long strips = (N + kStrip - 1) / kStrip;
      if (strips > 65535) return invalid;
      const dim3 grid(kCluster, static_cast<unsigned>(strips));
      if (route == kColsStream) {
        quantize_cols<T, KIND, false><<<grid, kColThreads, 0, st>>>(xp, qp, sp, M, N, fmax,
                                                                   mult, vec);
        break;
      }
      const long long bytes = (M + kCluster - 1LL) / kCluster * kStrip * sizeof(T);
      if (bytes > kSmemMax) return invalid;
      static const cudaError_t attr = allow_smem(quantize_cols<T, KIND, true>);
      if (attr != cudaSuccess) return static_cast<int>(attr);
      quantize_cols<T, KIND, true><<<grid, kColThreads, bytes, st>>>(xp, qp, sp, M, N, fmax,
                                                                    mult, vec);
      break;
    }
    default:
      return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kind(const void* x, void* q, void* scale, int M, int N, int out_kind, int route,
                int warps, int vecs, float fmax, float mult, cudaStream_t st) {
  switch (out_kind) {
    case kCodeE4M3:
      return launch<T, kCodeE4M3>(x, q, scale, M, N, route, warps, vecs, fmax, mult, st);
    case kCodeE5M2:
      return launch<T, kCodeE5M2>(x, q, scale, M, N, route, warps, vecs, fmax, mult, st);
    case kCodeInt8:
      return launch<T, kCodeInt8>(x, q, scale, M, N, route, warps, vecs, fmax, mult, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// in_kind: 0 float32, 1 bf16. out_kind: kCodeE4M3, kCodeE5M2 or kCodeInt8.
// route: kRowsRegs .. kColsStream (the rows routes write per-row scales [M],
// the columns routes per-column scales [N]); warps and vecs are rows_regs'
// warps a row and 16-byte vectors a lane (ignored by the other routes).
// mult = 2^margin. A route that does not fit the shape is refused.
extern "C" int quantize_launch(const void* x, void* q, void* scale, int M, int N,
                               int in_kind, int out_kind, int route, int warps, int vecs,
                               float fmax, float mult, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (in_kind == 0)
    return launch_kind<float>(x, q, scale, M, N, out_kind, route, warps, vecs, fmax, mult, st);
  if (in_kind == 1)
    return launch_kind<__nv_bfloat16>(x, q, scale, M, N, out_kind, route, warps, vecs, fmax,
                                      mult, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
