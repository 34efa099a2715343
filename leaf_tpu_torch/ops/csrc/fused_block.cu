// LayerNorm and GEMM + bias (+ residual) kernels of the fused attention block,
// for Hopper.
//
// Replaces: leaf_tpu/ops/packed_attention.py::fused_attention_block (Pallas
// kernel `_block_kernel`), which computes x + out_proj(attn(qkv_proj(LN_1(x))))
// with the 3D^2 + D^2 weights resident in TPU VMEM.  At D = 1024 those weights
// are 8 MiB in bf16, and a Hopper block has 227 KB of shared memory, so the
// block is split into four kernels that the Python wrapper launches in order on
// one stream:
//   1. layer_norm_kernel:  h = LN_1(x), fp32 statistics, written in x.dtype;
//   2. gemm_bias_kernel:   qkv = h @ qkv_w + qkv_b;
//   3. packed_attention.cu: attn = packed attention over qkv;
//   4. gemm_bias_kernel:   out = x + (attn @ out_w + out_b).
//
// Weight layout: W is [K, N] row-major, y = x @ W (the JAX package's layout).
// OpenCLIP's in_proj_weight [3D, D] is transposed once when a checkpoint is
// converted (models/interop.py), never at run time.
//
// Rounding points, as in the JAX kernel: LN in fp32, result rounded to the
// dtype; GEMMs accumulate in fp32; the bias is stored in the dtype and added
// in fp32 before the one rounding of the product; the residual add is a sum of
// two dtype values, rounded to the dtype.
//
// What bounds it on the H100: the two GEMMs are compute-bound (M = R*L tokens of
// 4096..32896 per batch, K = D, N = 3D or D); LayerNorm reads and writes each
// activation once and is bound by memory bandwidth.
//
// Design, simple first:
//   * bf16 GEMM: 128x128 block tile, 8 warps of 64x32, nvcuda::wmma 16x16x16
//     tiles with fp32 accumulators, K steps of 32 staged in shared memory by
//     cp.async in two stages (the next tile loads while this one multiplies);
//     the epilogue goes through a 16x16 fp32 tile per warp in shared memory.
//   * fp32 GEMM: 64x64 block tile, 4x4 outputs per thread, FMA in fp32
//     (no TF32), A staged transposed so that each thread reads 4 rows at once.
//   * LayerNorm: one warp per token, two passes over the row (mean, then
//     variance of x - mean), as leaf_tpu/models/layers.py::layer_norm.
// wgmma, TMA and persistent scheduling are left to later work.
#include <mma.h>

#include "common.cuh"

namespace {

using leaf::from_float;
using leaf::round_to;
using leaf::to_float;

// ---------------------------------------------------------------------------
// LayerNorm
// ---------------------------------------------------------------------------

constexpr int kLnWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                  float eps) {
  const int tok = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= M) return;
  const T* xr = x + (size_t)tok * D;
  T* yr = y + (size_t)tok * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_float(xr[d]);
  const float mean = leaf::warp_sum(s) / D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float t = to_float(xr[d]) - mean;
    v += t * t;
  }
  const float rstd = 1.f / sqrtf(leaf::warp_sum(v) / D + eps);
  for (int d = lane; d < D; d += 32)
    yr[d] = from_float<T>((to_float(xr[d]) - mean) * rstd * scale[d] + bias[d]);
}

// ---------------------------------------------------------------------------
// bf16 GEMM + bias (+ residual): tensor cores through nvcuda::wmma
// ---------------------------------------------------------------------------

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kGemmThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kFragsM = kWarpM / 16, kFragsN = kWarpN / 16;
constexpr int kALd = kBK + 8;  // padded smem rows (multiples of 8 elements)
constexpr int kBLd = kBN + 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes = 8 bf16 values <-> 8 floats
__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) leaf::Word<bf16>::unpack(w[i], f + 2 * i);
}
__device__ __forceinline__ uint4 pack8(const float* f) {
  return make_uint4(leaf::Word<bf16>::pack(f), leaf::Word<bf16>::pack(f + 2),
                    leaf::Word<bf16>::pack(f + 4), leaf::Word<bf16>::pack(f + 6));
}

__global__ void __launch_bounds__(kGemmThreads)
gemm_bias_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                      const bf16* __restrict__ bias, const bf16* __restrict__ residual,
                      bf16* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[2][kBM * kALd];
  __shared__ __align__(128) bf16 Bs[2][kBK * kBLd];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;

  auto load_tile = [&](int stage, int k0) {
    // A: kBM x kBK = 512 chunks of 8; B: kBK x kBN = 512 chunks of 8
    for (int c = tid; c < kBM * kBK / 8; c += kGemmThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const bool ok = bm + r < M && k0 + col < K;
      const bf16* src = ok ? A + (size_t)(bm + r) * K + k0 + col : A;
      cp_async16(&As[stage][r * kALd + col], src, ok);
    }
    for (int c = tid; c < kBK * kBN / 8; c += kGemmThreads) {
      const int r = c / (kBN / 8), col = (c % (kBN / 8)) * 8;
      const bool ok = k0 + r < K && bn + col < N;
      const bf16* src = ok ? W + (size_t)(k0 + r) * N + bn + col : W;
      cp_async16(&Bs[stage][r * kBLd + col], src, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragsM][kFragsN];
#pragma unroll
  for (int i = 0; i < kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int k_tiles = (K + kBK - 1) / kBK;
  load_tile(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load_tile((kt + 1) & 1, (kt + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As[kt & 1];
    const bf16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kFragsM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[kFragsN];
#pragma unroll
      for (int i = 0; i < kFragsM; ++i)
        wmma::load_matrix_sync(a[i], as + (wm * kWarpM + i * 16) * kALd + kk, kALd);
#pragma unroll
      for (int j = 0; j < kFragsN; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kBLd + wn * kWarpN + j * 16, kBLd);
#pragma unroll
      for (int i = 0; i < kFragsM; ++i)
#pragma unroll
        for (int j = 0; j < kFragsN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the stage just read is the next load's target
  }

  // epilogue: one 16x16 fragment at a time through this warp's fp32 tile;
  // each lane finishes 8 consecutive outputs of one row
  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFragsM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = bm + wm * kWarpM + i * 16 + r;
      const int n = bn + wn * kWarpN + j * 16 + c;
      if (m < M && n < N) {
        float b[8], v[8];
        unpack8(*reinterpret_cast<const uint4*>(bias + n), b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = round_to<bf16>(cs[r * 16 + c + e] + b[e]);
        if (residual != nullptr) {
          float x[8];
          unpack8(*reinterpret_cast<const uint4*>(residual + (size_t)m * N + n), x);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = x[e] + v[e];
        }
        *reinterpret_cast<uint4*>(out + (size_t)m * N + n) = pack8(v);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 GEMM + bias (+ residual): FMA, no TF32
// ---------------------------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;
constexpr int kFThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFThreads)
gemm_bias_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                     const float* __restrict__ bias, const float* __restrict__ residual,
                     float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[kFBK][kFBM];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[kFBK][kFBN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bm = blockIdx.y * kFBM, bn = blockIdx.x * kFBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFBK) {
    {  // A: 64 rows x 16 cols, one float4 per thread
      const int r = tid / 4, col = (tid % 4) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bm + r < M && k0 + col < K)
        a = *reinterpret_cast<const float4*>(A + (size_t)(bm + r) * K + k0 + col);
      As[col + 0][r] = a.x;
      As[col + 1][r] = a.y;
      As[col + 2][r] = a.z;
      As[col + 3][r] = a.w;
    }
    {  // W: 16 rows x 64 cols, one float4 per thread
      const int r = tid / 16, col = (tid % 16) * 4;
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < K && bn + col < N)
        b = *reinterpret_cast<const float4*>(W + (size_t)(k0 + r) * N + bn + col);
      *reinterpret_cast<float4*>(&Bs[r][col]) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = bm + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = bn + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (residual != nullptr) v = residual[(size_t)m * N + n] + v;
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

extern "C" int leaf_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                               int dtype, int M, int D, float eps, int device,
                               void* stream) {
  if (M <= 0 || D <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kLnWarps - 1) / kLnWarps);
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case leaf::kFloat32:
      layer_norm_kernel<float><<<grid, kLnWarps * 32, 0, s>>>(
          static_cast<const float*>(x), g, b, static_cast<float*>(y), M, D, eps);
      break;
    case leaf::kBFloat16:
      layer_norm_kernel<bf16><<<grid, kLnWarps * 32, 0, s>>>(
          static_cast<const bf16*>(x), g, b, static_cast<bf16*>(y), M, D, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out[M, N] = (residual +) A[M, K] @ W[K, N] + bias[N]; residual may be null.
extern "C" int leaf_gemm_bias(const void* a, const void* w, const void* bias,
                              const void* residual, void* out, int dtype, int M, int N,
                              int K, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case leaf::kFloat32: {
      if (N % 4 != 0 || K % 4 != 0) return cudaErrorInvalidValue;
      const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
      gemm_bias_f32_kernel<<<grid, kFThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(w),
          static_cast<const float*>(bias), static_cast<const float*>(residual),
          static_cast<float*>(out), M, N, K);
      break;
    }
    case leaf::kBFloat16: {
      if (N % 8 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
      const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
      gemm_bias_bf16_kernel<<<grid, kGemmThreads, 0, s>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(w),
          static_cast<const bf16*>(bias), static_cast<const bf16*>(residual),
          static_cast<bf16*>(out), M, N, K);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
