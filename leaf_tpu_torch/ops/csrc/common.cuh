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

// ---- copies and tensor-core fragments shared by the kernels ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements, or four 8 x 4 of 32-bit ones: lane
// l gives the address of row l % 8 of matrix l / 8 and receives, of each
// matrix, the 32-bit word l % 4 of row l / 4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---- fp32 products on the TF32 tensor cores, to fp32 accuracy (3xTF32) ----
//
// A TF32 operand keeps 11 significant bits.  Each fp32 operand is split as
// x = hi + lo: hi is x rounded to 11 bits (to nearest, ties away from zero:
// an integer add at bit 12 and a mask, 2 operations; Veltkamp's split in
// fp32 (3) and `cvt.rna.tf32.f32` were both slower in the GEMM), lo = x - hi
// exactly (|lo| <= 2^-11 |x|), which the tensor core reads to its 11 leading
// bits.  A product is then hi*hi + hi*lo + lo*hi, the small terms first.
// What is dropped, lo*lo (<= 2^-22 of the product) and the bits of lo past 11
// (<= 2^-21), is ~100x below the one TF32 pass's error (2^-11) and well
// inside the fp32 limits (1e-4).  The tensor core truncates each sum it
// accumulates (at most an ulp of the accumulator, always towards zero), so a
// long sum takes partial sums in a fresh accumulator and adds them in fp32
// (the fp32 GEMM).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 operands, fp32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); c0, c1 (g, 2t, 2t + 1),
// c2, c3 (g + 8, 2t, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b to fp32 accuracy: a = ah + al and b = (bh0, bh1) + (bl0, bl1)
// as split by split_tf32; three TF32 products, the small ones first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

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
