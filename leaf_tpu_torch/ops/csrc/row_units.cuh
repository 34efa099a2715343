// A LayerNorm row's units, shared by the forward (layer_norm.cu) and the
// backward (layer_norm_backward.cu): 16-byte pieces and the 4-byte words or
// single bf16 elements of a row's head and tail, unpacked to and packed from
// floats, and the fp32 parameters that go with them.
#pragma once

#include "common.cuh"

namespace leaf {
namespace ln {

using bf16 = __nv_bfloat16;

// ---- a row's pieces (16 bytes) and edge units (4 bytes, one bf16), as floats ----

template <typename T, typename U> struct Unit;
template <typename T> struct Unit<T, uint4> {
  static constexpr int kE = 16 / sizeof(T);
  __device__ __forceinline__ static void unpack(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) leaf::Word<T>::unpack(w[i], f + i * leaf::Word<T>::kElems);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    constexpr int kW = leaf::Word<T>::kElems;
    return make_uint4(leaf::Word<T>::pack(f), leaf::Word<T>::pack(f + kW),
                      leaf::Word<T>::pack(f + 2 * kW), leaf::Word<T>::pack(f + 3 * kW));
  }
};
template <typename T> struct Unit<T, uint32_t> {
  static constexpr int kE = 4 / sizeof(T);
  __device__ __forceinline__ static void unpack(uint32_t u, float* f) {
    leaf::Word<T>::unpack(u, f);
  }
  __device__ __forceinline__ static uint32_t pack(const float* f) {
    return leaf::Word<T>::pack(f);
  }
};
template <> struct Unit<bf16, uint16_t> {
  static constexpr int kE = 1;
  __device__ __forceinline__ static void unpack(uint16_t u, float* f) {
    f[0] = __uint_as_float(static_cast<uint32_t>(u) << 16);
  }
  __device__ __forceinline__ static uint16_t pack(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16(f[0]));
  }
};

// kE fp32 parameters from p (aligned to kE floats, at most 16 bytes a load)
template <int kE>
__device__ __forceinline__ void load_params(const float* __restrict__ p, float* f) {
  if constexpr (kE % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kE; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x;
      f[i + 1] = v.y;
      f[i + 2] = v.z;
      f[i + 3] = v.w;
    }
  } else if constexpr (kE == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x;
    f[1] = v.y;
  } else {
    f[0] = *p;
  }
}

// kE fp32 parameters from p, which lies `shift` floats past a boundary of
// kE floats (a row's pieces start where its head ends)
template <int kE>
__device__ __forceinline__ void load_params_at(const float* __restrict__ p, float* f,
                                               int shift) {
  if (shift % 4 == 0) {
    load_params<kE>(p, f);
  } else if (shift % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kE; i += 2) load_params<2>(p + i, f + i);
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i) f[i] = p[i];
  }
}

// the unit of a row's head and tail: a 4-byte word, or (bf16 rows of odd
// width, 2-byte aligned) one element
template <typename T, int kEdge> struct EdgeUnit { using type = uint32_t; };
template <> struct EdgeUnit<bf16, 2> { using type = uint16_t; };

}  // namespace ln
}  // namespace leaf
