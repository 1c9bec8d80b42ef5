// Shared device helpers of the port's kernels: fp8 → float by the TPU
// kernels' shift + power-of-two route, with subnormal codes flushed to ±0
// (the Hopper counterpart of llm_fp8_tpu/kernels/_common.py:10-51).
//
// The TPU route re-seats a code's 7 payload bits in a bf16 bit pattern and
// rebiases with one multiply; the TPU's vector unit flushes the bf16
// subnormals that format subnormals land on. Hopper's cvt and float
// arithmetic are exact on subnormals, so the flush here is explicit
// (exponent field 0 → ±0). Every normal code is exact; e4m3 0x7F/0xFF map to
// ±480 and e5m2 exponent-31 codes to finite values, as on the TPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage kinds shared with the Python wrappers (kernels/_common.py).
enum : int { kCodeE4M3 = 0, kCodeE5M2 = 1, kCodeInt8 = 2, kCodeBF16 = 3 };

__device__ __forceinline__ float e4m3_ftz_to_float(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t bits = (b & 0x78u) == 0u ? sign : (sign | ((b & 0x7Fu) << 20));
  return __uint_as_float(bits) * __uint_as_float(0x7B800000u);  // × 2^120
}

__device__ __forceinline__ float e5m2_ftz_to_float(uint32_t b) {
  const uint32_t sign = (b & 0x80u) << 24;
  const uint32_t bits = (b & 0x7Cu) == 0u ? sign : (sign | ((b & 0x7Fu) << 21));
  return __uint_as_float(bits) * __uint_as_float(0x77800000u);  // × 2^112
}

// e5m2 → float exactly (subnormals kept): e5m2 is the top byte of an fp16.
__device__ __forceinline__ float e5m2_exact_to_float(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b << 8)));
}

// One stored byte → float (its bf16 value; int8 converts exactly).
template <int KIND>
__device__ __forceinline__ float code_to_float(uint32_t b) {
  if constexpr (KIND == kCodeE4M3) return e4m3_ftz_to_float(b);
  else if constexpr (KIND == kCodeE5M2) return e5m2_ftz_to_float(b);
  else return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
}

// Largest finite magnitude of a storage kind (the clip before the cast).
template <int KIND>
__device__ __forceinline__ float kind_max() {
  if constexpr (KIND == kCodeE4M3) return 448.0f;
  else if constexpr (KIND == kCodeE5M2) return 57344.0f;
  else return 127.0f;
}

// Clipped float → stored byte, round to nearest even (rintf for int8).
template <int KIND>
__device__ __forceinline__ uint8_t float_to_code(float v) {
  if constexpr (KIND == kCodeE4M3)
    return static_cast<uint8_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  else if constexpr (KIND == kCodeE5M2)
    return static_cast<uint8_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2));
  else return static_cast<uint8_t>(static_cast<int8_t>(rintf(v)));
}

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Every launcher returns cudaGetLastError(); the wrapper turns a non-zero
// code into an exception with this string.
extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
