// Helpers shared by the port's CUDA kernels (sm_90a, nvcc, plain C interface).
//
// Element types: dtype code 0 is float32, 1 is bfloat16, matching
// leaf_tpu_torch/ops/packed_attention.py::_DTYPE_CODES.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace leaf {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// v rounded to T and widened back to float: the JAX kernels' `.astype(dtype)`
// at the points where a value is stored in the working dtype.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// A 32-bit word of T values: one float, or two bf16 (lower address in the
// low half, as in memory).
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int kElems = 1;
  __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int kElems = 2;
  __device__ __forceinline__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace leaf
