// LayerNorm over the last dimension, for Hopper: the first stage of the fused
// attention block (fused_block.cu calls `leaf_layer_norm`) and the LayerNorm
// op of every other LayerNorm in the towers.
//
// Replaces: the LayerNorm stage of leaf_tpu/ops/packed_attention.py's Pallas
// kernel `_block_kernel`, with the numerics of leaf_tpu/models/layers.py::
// layer_norm: fp32 statistics in two passes (the mean, then the mean of
// (x - mean)^2, never E[x^2] - mean^2), the output (x - mean) * rstd * scale +
// bias in fp32, rounded once to x's dtype; scale and bias are fp32.
//
// What bounds it on the H100: it reads and writes each activation once, a
// handful of operations an element: the bytes (3.35 TB/s).  A kernel gets
// near that only if every row is read once, in wide loads, with enough bytes
// in flight on every SM (~25 KB at ~1 us of latency), and the three passes
// run on chip.
//
// Design.  A row moves in aligned 16-byte pieces.  Where its bytes are no
// whole number of pieces (EVA02-L's 2730 bf16 rows start 5,460 bytes apart:
// only every fourth is 16-byte aligned), the pieces start at the row's first
// 16-byte boundary and the few bytes before it (the head) and after the
// last piece (the tail) move as 4-byte words, one a thread: `edge` 4.  Only
// bf16 rows of odd width, whose rows start on 2-byte boundaries, take their
// edges as single elements (`edge` 2).  A row's pieces are spread over
// `threads` threads of a block of 256, piece c of thread t being
// t + threads * c, and stay in registers from the one read to the one
// write; the sums cross the row's threads by shuffle and, past a warp,
// through shared memory.  `make_plan` picks, from the width, the dtype and
// whether every pointer is 16-byte aligned:
//   * rows: whole pieces, D <= 1024, 32 or more pieces: a warp a row and up
//     to 1024 / (32 * elements a piece) pieces a lane;
//   * registers, narrow: whole pieces, fewer than 32 (ConvNeXt's and Swin's
//     128-channel stems, ViTamin's 160, bf16): 4 or 8 threads a row, 4
//     pieces a thread at most, so that a warp holds 4 or 8 rows, no lane
//     idles for want of a row, and a thread keeps 64 bytes in flight (the
//     rows kernel left 12-16 lanes of a warp idle there);
//   * registers, wide: any other row (D > 1024, or with edges) on a warp
//     while its pieces fit 64 registers of a thread (16 pieces), else on 2,
//     4 or 8 warps with the statistics crossing warps through shared
//     memory; the compiled count of pieces a thread (8 or 16) is the least
//     that holds the row, and the loop masks what the row does not fill;
//   * global: rows past 256 threads' registers (D > 16,384 in fp32, 32,768
//     in bf16), and pointers off 16-byte boundaries, which the op's checks
//     and allocations never give: three passes over the row in global
//     memory, a warp a row.  No model of the repository has such a row.
// `leaf_layer_norm_plan` gives the plan; ops/packed_attention.py::
// layer_norm_plan mirrors it in Python, and chip_smoke.py holds the two
// equal at every row it times.
#include "row_units.cuh"

namespace {

using bf16 = __nv_bfloat16;
using leaf::ln::EdgeUnit;
using leaf::ln::load_params;
using leaf::ln::load_params_at;
using leaf::ln::Unit;

constexpr int kLnThreads = 256;  // a block
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kRowRegs = 64;     // 32-bit registers of row data a thread may hold

enum Variant { kRowsVariant = 0, kRegsVariant = 1, kGlobalVariant = 2 };

struct LnPlan {
  int variant;
  int unit;     // bytes a load of the row's body moves: 16 (global: the element)
  int edge;     // bytes a load of its head and tail moves: 0 (none), 4 or 2
  int threads;  // threads a row
  int per;      // pieces a thread holds, as compiled (the row may fill fewer)
  int rows;     // rows a block
};

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// aligned: x, y, scale and bias all on 16-byte boundaries
LnPlan make_plan(int D, int esize, bool aligned) {
  LnPlan pl;
  const long long bytes = (long long)D * esize;
  const long long pieces = bytes / 16;  // at most; a row with edges may hold one fewer
  constexpr int kCap = kRowRegs / 4;    // pieces a thread may hold
  pl.unit = 16;
  pl.edge = bytes % 16 == 0 ? 0 : bytes % 4 == 0 ? 4 : esize;
  int warps = 1;
  while (warps < kLnWarps && ceil_div(pieces, 32 * warps) > kCap) warps *= 2;
  const int need = ceil_div(pieces, 32 * warps);
  if (!aligned || need > kCap) {
    pl.variant = kGlobalVariant;
    pl.unit = esize;
    pl.edge = 0;
    pl.threads = 32;
    pl.per = 0;
  } else if (pl.edge == 0 && pieces >= 32 && D <= 1024) {
    pl.variant = kRowsVariant;
    pl.threads = 32;
    pl.per = 1024 / (32 * (16 / esize));
  } else if (pl.edge == 0 && pieces < 32) {
    pl.variant = kRegsVariant;
    pl.threads = pieces <= 16 ? 4 : 8;
    pl.per = 4;
  } else {
    pl.variant = kRegsVariant;
    pl.threads = 32 * warps;
    pl.per = need <= 8 ? 8 : 16;
  }
  pl.rows = kLnThreads / pl.threads;
  return pl;
}

// The sum of v over the kThreads threads of a row (consecutive threads, the
// same in all of them); past a warp through `red`, one float a warp of the
// block, and a block barrier that every thread of the block reaches.
template <int kThreads>
__device__ __forceinline__ float row_sum(float v, float* red) {
  constexpr int kLanes = kThreads < 32 ? kThreads : 32;
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (kThreads > 32) {
    constexpr int kWarps = kThreads / 32;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / kWarps * kWarps;
    v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[first + w];
  }
  return v;
}

// ---------------------------------------------------------------------------
// registers: a row of 16-byte pieces spread over kThreads threads, kPer
// pieces each; kEdge: the bytes of a head or tail unit (0: the rows are whole
// pieces, every one starting on a 16-byte boundary)
// ---------------------------------------------------------------------------

template <typename T, int kEdge, int kThreads, int kPer>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_regs_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                       float eps) {
  using Un = Unit<T, uint4>;
  using Ed = Unit<T, typename EdgeUnit<T, kEdge>::type>;
  using EdgeWord = typename EdgeUnit<T, kEdge>::type;
  constexpr int kE = Un::kE;
  constexpr int kEE = Ed::kE;  // elements of an edge unit
  constexpr int kRows = kLnThreads / kThreads;
  __shared__ float red[2][kLnWarps];
  const int t = threadIdx.x % kThreads;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / kThreads;
  // a thread past the last row loads nothing but takes part in the sums
  const bool live = row < M;
  const size_t offset = live ? (size_t)row * D : 0;
  // the row's head: its elements before the first 16-byte boundary (x is
  // 16-byte aligned), at most the row
  int h = 0;
  if constexpr (kEdge > 0) {
    h = (int)((16 - offset * sizeof(T) % 16) % 16 / sizeof(T));
    h = h < D ? h : D;
  }
  const int pieces = (D - h) / kE;
  const int tail0 = h + pieces * kE;  // the tail's first element
  const uint4* xr = reinterpret_cast<const uint4*>(x + offset + h);
  auto held = [&](int c) { return live && t + kThreads * c < pieces; };
  // edge units: thread t holds head unit t and tail unit t, if any
  const bool has_head = kEdge > 0 && live && t < h / kEE;
  const bool has_tail = kEdge > 0 && live && t < (D - tail0) / kEE;

  uint4 v[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (held(c)) v[c] = xr[t + kThreads * c];
  EdgeWord head = 0, tail = 0;
  if (has_head) head = reinterpret_cast<const EdgeWord*>(x + offset)[t];
  if (has_tail) tail = reinterpret_cast<const EdgeWord*>(x + offset + tail0)[t];

  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (held(c)) {
      float f[kE];
      Un::unpack(v[c], f);
#pragma unroll
      for (int e = 0; e < kE; ++e) s += f[e];
    }
  float fh[kEE], ft[kEE];
  Ed::unpack(head, fh);
  Ed::unpack(tail, ft);
#pragma unroll
  for (int e = 0; e < kEE; ++e) s += (has_head ? fh[e] : 0.f) + (has_tail ? ft[e] : 0.f);
  const float mean = row_sum<kThreads>(s, red[0]) / D;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (held(c)) {
      float f[kE];
      Un::unpack(v[c], f);
#pragma unroll
      for (int e = 0; e < kE; ++e) q += (f[e] - mean) * (f[e] - mean);
    }
#pragma unroll
  for (int e = 0; e < kEE; ++e) {
    if (has_head) q += (fh[e] - mean) * (fh[e] - mean);
    if (has_tail) q += (ft[e] - mean) * (ft[e] - mean);
  }
  const float rstd = 1.f / sqrtf(row_sum<kThreads>(q, red[1]) / D + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + offset + h);
#pragma unroll
  for (int c = 0; c < kPer; ++c)
    if (held(c)) {
      const int i = h + (t + kThreads * c) * kE;  // the piece's first element
      float f[kE], g[kE], b[kE];
      Un::unpack(v[c], f);
      if constexpr (kEdge > 0) {
        load_params_at<kE>(scale + i, g, h);
        load_params_at<kE>(bias + i, b, h);
      } else {
        load_params<kE>(scale + i, g);
        load_params<kE>(bias + i, b);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] = (f[e] - mean) * rstd * g[e] + b[e];
      yr[t + kThreads * c] = Un::pack(f);
    }
  if constexpr (kEdge > 0) {
    // the head and tail units start at multiples of kEE elements
    float g[kEE], b[kEE];
    if (has_head) {
      load_params<kEE>(scale + t * kEE, g);
      load_params<kEE>(bias + t * kEE, b);
#pragma unroll
      for (int e = 0; e < kEE; ++e) fh[e] = (fh[e] - mean) * rstd * g[e] + b[e];
      reinterpret_cast<EdgeWord*>(y + offset)[t] = Ed::pack(fh);
    }
    if (has_tail) {
      load_params<kEE>(scale + tail0 + t * kEE, g);
      load_params<kEE>(bias + tail0 + t * kEE, b);
#pragma unroll
      for (int e = 0; e < kEE; ++e) ft[e] = (ft[e] - mean) * rstd * g[e] + b[e];
      reinterpret_cast<EdgeWord*>(y + offset + tail0)[t] = Ed::pack(ft);
    }
  }
}

// ---------------------------------------------------------------------------
// rows: whole 16-byte pieces, at most 32 * kPieces of them; lane l
// keeps pieces l, l + 32, ... in registers from the one read to the one write
// ---------------------------------------------------------------------------

template <typename T, int kPieces>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                       float eps) {
  constexpr int kE = 16 / sizeof(T);  // elements of a piece
  const int tok = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= M) return;
  const int pieces = D / kE;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)tok * D);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)tok * D);
  uint4 row[kPieces];
#pragma unroll
  for (int c = 0; c < kPieces; ++c)
    if (lane + 32 * c < pieces) row[c] = xr[lane + 32 * c];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    if (lane + 32 * c < pieces) {
      float f[kE];
      Unit<T, uint4>::unpack(row[c], f);
#pragma unroll
      for (int e = 0; e < kE; ++e) s += f[e];
    }
  }
  const float mean = leaf::warp_sum(s) / D;
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    if (lane + 32 * c < pieces) {
      float f[kE];
      Unit<T, uint4>::unpack(row[c], f);
#pragma unroll
      for (int e = 0; e < kE; ++e) v += (f[e] - mean) * (f[e] - mean);
    }
  }
  const float rstd = 1.f / sqrtf(leaf::warp_sum(v) / D + eps);
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const int piece = lane + 32 * c;
    if (piece < pieces) {
      float f[kE];
      Unit<T, uint4>::unpack(row[c], f);
#pragma unroll
      for (int e = 0; e < kE; e += 4) {
        const float4 g = *reinterpret_cast<const float4*>(scale + piece * kE + e);
        const float4 b = *reinterpret_cast<const float4*>(bias + piece * kE + e);
        f[e + 0] = (f[e + 0] - mean) * rstd * g.x + b.x;
        f[e + 1] = (f[e + 1] - mean) * rstd * g.y + b.y;
        f[e + 2] = (f[e + 2] - mean) * rstd * g.z + b.z;
        f[e + 3] = (f[e + 3] - mean) * rstd * g.w + b.w;
      }
      yr[piece] = Unit<T, uint4>::pack(f);
    }
  }
}

// ---------------------------------------------------------------------------
// global: rows wider than a block's registers; three passes over the
// row in global memory, a warp a row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kLnWarps * 32)
layer_norm_global_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                         float eps) {
  const int tok = blockIdx.x * kLnWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (tok >= M) return;
  const T* xr = x + (size_t)tok * D;
  T* yr = y + (size_t)tok * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += leaf::to_float(xr[d]);
  const float mean = leaf::warp_sum(s) / D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float t = leaf::to_float(xr[d]) - mean;
    v += t * t;
  }
  const float rstd = 1.f / sqrtf(leaf::warp_sum(v) / D + eps);
  for (int d = lane; d < D; d += 32)
    yr[d] = leaf::from_float<T>((leaf::to_float(xr[d]) - mean) * rstd * scale[d] + bias[d]);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct LnArgs {
  const void* x;
  const float* scale;
  const float* bias;
  void* y;
  int M, D;
  float eps;
  cudaStream_t stream;
};

template <typename T, int kEdge, int kThreads, int kPer>
cudaError_t launch_regs(const LnArgs& a) {
  constexpr int kRows = kLnThreads / kThreads;
  const unsigned blocks = (unsigned)ceil_div(a.M, kRows);
  layer_norm_regs_kernel<T, kEdge, kThreads, kPer><<<blocks, kLnThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, a.bias, static_cast<T*>(a.y), a.M, a.D, a.eps);
  return cudaGetLastError();
}

// every (threads, per) pair that make_plan gives for rows with kEdge edges
template <typename T, int kEdge>
cudaError_t launch_plan(const LnPlan& pl, const LnArgs& a) {
  if constexpr (kEdge == 0) {
    if (pl.threads == 4) return launch_regs<T, 0, 4, 4>(a);
    if (pl.threads == 8) return launch_regs<T, 0, 8, 4>(a);
  }
  if (pl.threads == 32 && pl.per == 8) return launch_regs<T, kEdge, 32, 8>(a);
  if (pl.threads == 32) return launch_regs<T, kEdge, 32, 16>(a);
  if (pl.threads == 64) return launch_regs<T, kEdge, 64, 16>(a);
  if (pl.threads == 128) return launch_regs<T, kEdge, 128, 16>(a);
  if (pl.threads == 256) return launch_regs<T, kEdge, 256, 16>(a);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_layer_norm(const LnArgs& a) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.y) |
                        reinterpret_cast<uintptr_t>(a.scale) |
                        reinterpret_cast<uintptr_t>(a.bias)) % 16 == 0;
  const LnPlan pl = make_plan(a.D, sizeof(T), aligned);
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  switch (pl.variant) {
    case kRowsVariant: {
      constexpr int kPieces = 1024 / (32 * (16 / sizeof(T)));
      layer_norm_rows_kernel<T, kPieces><<<ceil_div(a.M, kLnWarps), kLnThreads, 0, a.stream>>>(
          x, a.scale, a.bias, y, a.M, a.D, a.eps);
      return cudaGetLastError();
    }
    case kRegsVariant:
      if (pl.edge == 0) return launch_plan<T, 0>(pl, a);
      if (pl.edge == 4) return launch_plan<T, 4>(pl, a);
      if constexpr (sizeof(T) == 2) return launch_plan<T, 2>(pl, a);
      return cudaErrorInvalidValue;
    default:
      layer_norm_global_kernel<T><<<ceil_div(a.M, kLnWarps), kLnThreads, 0, a.stream>>>(
          x, a.scale, a.bias, y, a.M, a.D, a.eps);
      return cudaGetLastError();
  }
}

int element_size(int dtype) {
  return dtype == leaf::kFloat32 ? 4 : dtype == leaf::kBFloat16 ? 2 : 0;
}

}  // namespace

extern "C" int leaf_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                               int dtype, int M, int D, float eps, int device,
                               void* stream) {
  if (M <= 0 || D <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const LnArgs a = {x, static_cast<const float*>(scale), static_cast<const float*>(bias), y,
                    M, D, eps, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case leaf::kFloat32:
      return launch_layer_norm<float>(a);
    case leaf::kBFloat16:
      return launch_layer_norm<bf16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The LayerNorm kernel's plan for rows of D elements of `dtype`, aligned: x, y,
// scale and bias on 16-byte boundaries.  Computed on the host, launching
// nothing: plan = {variant (0 rows, 1 registers, 2 global), unit and edge
// bytes, threads a row, pieces a thread as compiled, rows a block}; returns 0,
// or a CUDA error code for a dtype or width the kernel does not take.
extern "C" int leaf_layer_norm_plan(int D, int dtype, int aligned, int* plan) {
  const int esize = element_size(dtype);
  if (D <= 0 || esize == 0) return cudaErrorInvalidValue;
  const LnPlan pl = make_plan(D, esize, aligned != 0);
  const int fields[6] = {pl.variant, pl.unit, pl.edge, pl.threads, pl.per, pl.rows};
  for (int i = 0; i < 6; ++i) plan[i] = fields[i];
  return 0;
}
