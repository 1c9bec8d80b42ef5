// K9: one-pass per-row or per-column amax + quantize of a 2-D operand.
//
// Replaces llm_fp8_tpu/kernels/quantize.py::quantize_fused (_kernel_rows,
// _kernel_cols). Input float32 or bf16 [M, N]; output codes (e4m3, e5m2 or
// int8) [M, N] and float32 scales, [M] for rows (amax over N) or [N] for
// columns (amax over M). The arithmetic is the plain version's
// (kernels/quantize.py::quantize_fused_plain) bit for bit:
//   scale = __fdiv_rn(max(amax, 1e-12), fmax) * 2^margin   (true division)
//   code  = cvt.rn.satfinite(clip(__fdiv_rn(x, scale)))     (rintf for int8)
//
// Bound on the H100: bytes. The training step's gradients are float32
// [4096, N] (N = 3072, 2048, 16384, 2048); one read and a one-byte write per
// element, e.g. 335 MB for gate|up, ~100 µs at 3.35 TB/s.
//
// Design: rows — one block of 256 threads per row; a strided pass takes the
// amax (warp shuffles, then across warps in shared memory), a second pass
// over the same row (from L1/L2) writes the codes. Columns — one block of 16
// warps per strip of 8 columns: a warp reads 4 rows x 8 neighbouring values
// (32-byte sectors of float32), the block walks the rows 64 at a time, the
// maxima meet in shared memory, and a second pass writes the codes. (A first
// version with 32-column strips and 8 warps gave 64 blocks at N = 2048 and
// ran slower than the plain version there.) A NaN propagates
// into the amax as in torch.amax; codes of non-finite inputs are not held to
// the plain version.
#include "fp8_ftz.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kColStrip = 8, kColWarps = 16;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float scale_of(float amax, float fmax, float mult) {
  return __fmul_rn(__fdiv_rn(fmaxf(amax, 1e-12f), fmax), mult);
}

template <int KIND>
__device__ __forceinline__ uint8_t code_of(float x, float scale, float fmax) {
  return float_to_code<KIND>(fminf(fmaxf(__fdiv_rn(x, scale), -fmax), fmax));
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kRowThreads)
quantize_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                     float* __restrict__ scale, int N, float fmax, float mult) {
  __shared__ float red[kRowThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * static_cast<size_t>(N);
  uint8_t* qr = q + row * static_cast<size_t>(N);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float m = 0.0f;
  for (int i = tid; i < N; i += kRowThreads) m = nan_max(m, fabsf(load_value(xr + i)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kRowThreads / 32 ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float s = scale_of(red[0], fmax, mult);
  if (tid == 0) scale[row] = s;
  for (int i = tid; i < N; i += kRowThreads) qr[i] = code_of<KIND>(load_value(xr + i), s, fmax);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kColWarps * 32)
quantize_cols_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                     float* __restrict__ scale, int M, int N, float fmax, float mult) {
  constexpr int kRows = kColWarps * (32 / kColStrip);  // rows one pass of the block covers
  __shared__ float red[kRows][kColStrip];
  __shared__ float s_col[kColStrip];
  const int lane = threadIdx.x % 32;
  const int c = lane % kColStrip;
  const int r0 = (threadIdx.x / 32) * (32 / kColStrip) + lane / kColStrip;
  const int col = blockIdx.x * kColStrip + c;
  const bool in = col < N;

  float m = 0.0f;
  if (in)
    for (int r = r0; r < M; r += kRows)
      m = nan_max(m, fabsf(load_value(x + static_cast<size_t>(r) * N + col)));
  red[r0][c] = m;
  __syncthreads();
  if (threadIdx.x < kColStrip) {
    float mm = red[0][threadIdx.x];
    for (int i = 1; i < kRows; ++i) mm = nan_max(mm, red[i][threadIdx.x]);
    const float s = scale_of(mm, fmax, mult);
    s_col[threadIdx.x] = s;
    const int cc = blockIdx.x * kColStrip + threadIdx.x;
    if (cc < N) scale[cc] = s;
  }
  __syncthreads();
  const float s = s_col[c];
  if (in)
    for (int r = r0; r < M; r += kRows) {
      const size_t i = static_cast<size_t>(r) * N + col;
      q[i] = code_of<KIND>(load_value(x + i), s, fmax);
    }
}

template <typename T, int KIND>
int launch(const void* x, void* q, void* scale, int M, int N, int axis, float fmax,
           float mult, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  uint8_t* qp = static_cast<uint8_t*>(q);
  float* sp = static_cast<float*>(scale);
  if (axis == 1)
    quantize_rows_kernel<T, KIND><<<M, kRowThreads, 0, st>>>(xp, qp, sp, N, fmax, mult);
  else
    quantize_cols_kernel<T, KIND><<<(N + kColStrip - 1) / kColStrip, kColWarps * 32, 0, st>>>(
        xp, qp, sp, M, N, fmax, mult);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kind(const void* x, void* q, void* scale, int M, int N, int out_kind, int axis,
                float fmax, float mult, cudaStream_t st) {
  switch (out_kind) {
    case kCodeE4M3: return launch<T, kCodeE4M3>(x, q, scale, M, N, axis, fmax, mult, st);
    case kCodeE5M2: return launch<T, kCodeE5M2>(x, q, scale, M, N, axis, fmax, mult, st);
    case kCodeInt8: return launch<T, kCodeInt8>(x, q, scale, M, N, axis, fmax, mult, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// in_kind: 0 float32, 1 bf16. out_kind: kCodeE4M3, kCodeE5M2 or kCodeInt8.
// axis 1: per-row scales [M]; axis 0: per-column scales [N]. mult = 2^margin.
extern "C" int quantize_launch(const void* x, void* q, void* scale, int M, int N,
                               int in_kind, int out_kind, int axis, float fmax,
                               float mult, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || (axis != 0 && axis != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_kind == 0)
    return launch_kind<float>(x, q, scale, M, N, out_kind, axis, fmax, mult, st);
  if (in_kind == 1)
    return launch_kind<__nv_bfloat16>(x, q, scale, M, N, out_kind, axis, fmax, mult, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
