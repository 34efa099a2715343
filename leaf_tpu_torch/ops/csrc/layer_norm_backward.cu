// The backward of the LayerNorm op and of the fused block's first stage, for
// Hopper.
//
// Replaces: the VJP of the LayerNorm in leaf_tpu/ops/packed_attention.py's
// `_block_bwd` (`jax.vjp` of `_block_reference`, whose `ln_1` is leaf_tpu/models/
// layers.py::layer_norm) and of every other LayerNorm of the towers, which XLA
// differentiates on the TPU; the Pallas file has no backward kernel.
//
// For rows x [M, D] (fp32 or bf16), fp32 scale [D] and the output's gradient
// dy [M, D] (x's dtype), with the forward's numerics (leaf_tpu_torch/ops/csrc/
// layer_norm.cu: mean, then the mean of (x - mean)^2, rstd = 1 / sqrt(var +
// eps), all fp32), recomputed here from x:
//   x^ = (x - mean) rstd,  g = dy scale
//   dx = rstd (g - mean(g) - x^ mean(g x^))         (fp32, rounded once to x's dtype)
//   dscale = sum over rows of dy x^,  dbias = sum over rows of dy   (fp32)
// The column sums are taken in two passes and no atomics, so two runs give
// the same bits: each block of the first kernel keeps its rows' sums in
// registers and writes them as one row of fp32 partials [2, blocks, D]; the
// second kernel adds a column's partials in a fixed order.  Where the caller
// wants the input's gradient alone (PGD through a frozen tower), no partials
// are written and the second kernel does not run.
//
// What bounds it on the H100: it reads x and dy once and writes dx once, a
// dozen operations an element: the bytes.  A block of 32 to 256 threads takes
// one row at a time, its elements t + threads k in registers from the one read
// to the one write (at most 8 a thread up to D = 2048, 12 up to 3072 (EVA02-L's
// 2730), 32 up to 8192); the statistics and the two row sums cross the block by
// shuffles and one shared-memory step.  `leaf_layer_norm_backward_plan` gives
// the plan; ops/packed_attention.py::layer_norm_backward_plan mirrors it.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxBlocks = 2048;  // blocks of the first kernel, at most
constexpr int kReduceWarps = 16;  // warps of a block of the second kernel

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

struct BwdPlan {
  int threads;  // threads a row (a block)
  int per;      // elements a thread holds, as compiled; 0: the width is not taken
  int blocks;   // blocks of the first kernel
  int rows;     // rows a block
};

BwdPlan make_plan(int M, int D) {
  BwdPlan pl;
  pl.threads = 32 * ceil_div(D, 32 * 8);
  if (pl.threads > kMaxThreads) pl.threads = kMaxThreads;
  const int need = ceil_div(D, pl.threads);
  pl.per = need <= 4 ? 4 : need <= 8 ? 8 : need <= 12 ? 12 : need <= 32 ? 32 : 0;
  pl.rows = ceil_div(M, kMaxBlocks);
  pl.blocks = ceil_div(M, pl.rows);
  return pl;
}

// the sums of v[0..N) over the block's threads, in every thread; `red` holds
// N floats a warp, and is this call's own (not reused before the next call
// of the same stage has passed its barrier)
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*red)[kMaxWarps]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = leaf::warp_sum(v[i]);
  const int warps = blockDim.x / 32;
  if (warps == 1) return;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][warp] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[i][w];
    v[i] = s;
  }
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_backward_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partials, int M, int D, int rows, float eps) {
  // a stage's sums: the mean's, the variance's, then (g, g x^) together
  __shared__ float red_mean[1][kMaxWarps], red_var[1][kMaxWarps], red_g[2][kMaxWarps];
  const int t = threadIdx.x, n = blockDim.x;
  float gam[kPer], dgam[kPer], dbet[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = t + n * k;
    gam[k] = c < D ? scale[c] : 0.f;
    dgam[k] = dbet[k] = 0.f;
  }
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = r0 + rows < M ? r0 + rows : M;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    float xv[kPer], dv[kPer];
    float s[1] = {0.f};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = t + n * k;
      xv[k] = c < D ? leaf::to_float(xr[c]) : 0.f;
      dv[k] = c < D ? leaf::to_float(dyr[c]) : 0.f;
      s[0] += xv[k];
    }
    block_sum<1>(s, red_mean);
    const float mean = s[0] / D;
    float q[1] = {0.f};
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (t + n * k < D) q[0] += (xv[k] - mean) * (xv[k] - mean);
    block_sum<1>(q, red_var);
    const float rstd = 1.f / sqrtf(q[0] / D + eps);
    float gs[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      xv[k] = (xv[k] - mean) * rstd;  // x^ (0 past D: dv is 0 there)
      const float gk = dv[k] * gam[k];
      gs[0] += gk;
      gs[1] += gk * xv[k];
    }
    block_sum<2>(gs, red_g);
    const float m1 = gs[0] / D, m2 = gs[1] / D;
    T* dxr = dx + row * D;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = t + n * k;
      if (c < D) {
        dxr[c] = leaf::from_float<T>(rstd * (dv[k] * gam[k] - m1 - xv[k] * m2));
        dgam[k] += dv[k] * xv[k];
        dbet[k] += dv[k];
      }
    }
  }
  if (partials == nullptr) return;
  float* pg = partials + (long long)blockIdx.x * D;
  float* pb = partials + ((long long)gridDim.x + blockIdx.x) * D;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = t + n * k;
    if (c < D) {
      pg[c] = dgam[k];
      pb[c] = dbet[k];
    }
  }
}

// dscale[c] and dbias[c]: the sums of the P partial rows' column c, each warp
// adding rows w, w + 16, ... in order, then warp 0 the 16 warps' sums in order
__global__ void __launch_bounds__(kReduceWarps * 32)
layer_norm_backward_reduce_kernel(const float* __restrict__ partials,
                                  float* __restrict__ dscale, float* __restrict__ dbias,
                                  int P, int D) {
  __shared__ float red[2][kReduceWarps][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float sg = 0.f, sb = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int p = w; p < P; p += kReduceWarps) {
      sg += partials[(long long)p * D + c];
      sb += partials[((long long)P + p) * D + c];
    }
  }
  red[0][w][lane] = sg;
  red[1][w][lane] = sb;
  __syncthreads();
  if (w == 0 && c < D) {
    float a = 0.f, b = 0.f;
    for (int v = 0; v < kReduceWarps; ++v) {
      a += red[0][v][lane];
      b += red[1][v][lane];
    }
    dscale[c] = a;
    dbias[c] = b;
  }
}

template <typename T, int kPer>
cudaError_t launch_rows(const BwdPlan& pl, const void* x, const float* scale, const void* dy,
                        void* dx, float* partials, int M, int D, float eps,
                        cudaStream_t stream) {
  layer_norm_backward_kernel<T, kPer><<<pl.blocks, pl.threads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx),
      partials, M, D, pl.rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_plan(const BwdPlan& pl, const void* x, const float* scale, const void* dy,
                        void* dx, float* partials, int M, int D, float eps,
                        cudaStream_t stream) {
  switch (pl.per) {
    case 4:
      return launch_rows<T, 4>(pl, x, scale, dy, dx, partials, M, D, eps, stream);
    case 8:
      return launch_rows<T, 8>(pl, x, scale, dy, dx, partials, M, D, eps, stream);
    case 12:
      return launch_rows<T, 12>(pl, x, scale, dy, dx, partials, M, D, eps, stream);
    case 32:
      return launch_rows<T, 32>(pl, x, scale, dy, dx, partials, M, D, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dx [M, D] (x's dtype) and, where `partials` is not null, dscale and dbias
// [D] (fp32) from x [M, D], the fp32 scale [D] and dy [M, D] (x's dtype, all
// contiguous); `partials` is fp32 scratch [2, blocks, D] of the plan's blocks.
extern "C" int leaf_layer_norm_backward(const void* x, const void* scale, const void* dy,
                                        void* dx, void* dscale, void* dbias, void* partials,
                                        int dtype, int M, int D, float eps, int device,
                                        void* stream) {
  if (M <= 0 || D <= 0) return cudaErrorInvalidValue;
  const BwdPlan pl = make_plan(M, D);
  if (pl.per == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const float* sc = static_cast<const float*>(scale);
  switch (dtype) {
    case leaf::kFloat32:
      err = launch_plan<float>(pl, x, sc, dy, dx, part, M, D, eps, s);
      break;
    case leaf::kBFloat16:
      err = launch_plan<__nv_bfloat16>(pl, x, sc, dy, dx, part, M, D, eps, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || part == nullptr) return err;
  layer_norm_backward_reduce_kernel<<<ceil_div(D, 32), kReduceWarps * 32, 0, s>>>(
      part, static_cast<float*>(dscale), static_cast<float*>(dbias), pl.blocks, D);
  return cudaGetLastError();
}

// The backward kernel's plan for M rows of D elements, computed on the host and
// launching nothing: plan = {threads a row, elements a thread as compiled (0:
// D is not taken), blocks, rows a block}; returns 0, or a CUDA error code.
extern "C" int leaf_layer_norm_backward_plan(int M, int D, int* plan) {
  if (M <= 0 || D <= 0) return cudaErrorInvalidValue;
  const BwdPlan pl = make_plan(M, D);
  const int fields[4] = {pl.threads, pl.per, pl.blocks, pl.rows};
  for (int i = 0; i < 4; ++i) plan[i] = fields[i];
  return 0;
}
