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
// The column sums take two passes and no atomics, so two runs give the same
// bits: the first kernel's threads add their rows' terms in registers, each
// block adds its threads' sums in a fixed order and writes them as one row of
// fp32 partials [2, blocks, D]; the second kernel adds a column's partials in
// a fixed order.  Where the caller wants the input's gradient alone (PGD
// through a frozen tower), no partials are written and the second kernel
// does not run.
//
// What bounds it on the H100: it reads x and dy once and writes dx once, a
// dozen operations an element: the bytes (3.35 TB/s).  A kernel gets near
// that only with enough bytes in flight on every SM and the row's three sums
// on chip.
//
// Design, on the pattern of the forward's plans (layer_norm.cu).  A row moves
// in aligned 16-byte pieces; where its bytes are no whole number of pieces
// (EVA02-L's 2730), its head (before its first 16-byte boundary) and tail
// move as 4-byte words, or single elements in bf16 rows of odd width.  A
// row's pieces are spread over `threads` threads, piece c of thread t being
// t + threads c.  A block of 256 threads is 256 / threads row streams; stream
// s of the grid takes rows s, s + S, s + 2S, ... (S streams).  Each thread
// copies its own pieces of the next two rows (kDepth - 1) into a ring of
// shared memory by `cp.async` (16 bytes, 4 for the edge words) before it
// reduces the current row, which it reads from the ring into registers once:
// x and dy stay there to the one write, and no barrier guards the ring, whose
// slots each thread alone writes and reads.  The copies in flight, 2 rows a
// stream, take no registers (a first version that prefetched one row into
// registers held up to 255 and lost to this one everywhere; a ring of 4 rows
// was slower than 3, its larger shared memory leaving less L1 cache beside
// it).  At FARE's rows the kernel moves ~2 TB/s (dx alone, chip_smoke.py
// (c)), at EVA02-L's ~1.4 TB/s: its rows take two warps, whose three sums a
// row wait at a barrier of the pair, with four rows an SM at a time.  S x D x the element
// size is a multiple of 16 (the grid is at most 264 blocks, a multiple of 8),
// so every row of a stream has the same 16-byte phase, hence the same columns
// in each thread: dscale and dbias add up in registers over the stream's rows.
// The row's sums cross its threads by shuffle and, past a warp, through
// shared memory behind a named barrier of the row's warps alone: no block
// barrier a row.  `make_plan` picks, from the width and the dtype:
//   * narrow: whole pieces, at most 64 (the 128- and 160-wide stems, the
//     512-wide text rows in bf16): 4, 8 or 16 threads a row, 4 pieces a
//     thread at most, several rows a warp;
//   * wide: a warp a row while the row is at most 6 pieces a lane (bf16 up
//     to 1536, fp32 to 768: FARE's 1280 bf16 rows), else 2, 4 or 8 warps (2
//     at EVA02-L's 2730); the compiled pieces a thread (4, 5, 6 or 8) is the
//     least that holds the row.  At most 4 pieces a lane (twice the warps)
//     was slower at FARE's and EVA02-L's rows.
// Rows of more than 32 KB (8 pieces a thread of a block) are refused.  The
// second kernel takes 8 columns a block and 32 streams of partial rows in
// each, so that D / 8 blocks fill the card (160 at D = 1280).
// `leaf_layer_norm_backward_plan` gives the plan; ops/packed_attention.py::
// layer_norm_backward_plan mirrors it.
#include "row_units.cuh"

namespace {

using bf16 = __nv_bfloat16;
using leaf::ln::EdgeUnit;
using leaf::ln::load_params;
using leaf::ln::load_params_at;
using leaf::ln::Unit;

constexpr int kThreads = 256;        // a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;      // blocks of the first kernel: 2 an SM, a multiple of 8
constexpr int kMaxRowBytes = 32768;  // 2048 pieces: 8 a thread of a block
constexpr int kReduceCols = 8;       // columns of a block of the second kernel
constexpr int kReduceStreams = kThreads / kReduceCols;
constexpr int kDepth = 3;            // rows of a stream's ring: the current and two ahead

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

struct BwdPlan {
  int threads;  // threads a row
  int per;      // pieces a thread holds, as compiled; 0: the width is not taken
  int edge;     // bytes of a head or tail unit: 0 (whole pieces), 4 or 2
  int rows;     // row streams a block
  int blocks;   // blocks of the first kernel
};

BwdPlan make_plan(int M, int D, int esize) {
  BwdPlan pl;
  const long long bytes = (long long)D * esize;
  const int pieces = (int)(bytes / 16);
  pl.edge = bytes % 16 == 0 ? 0 : bytes % 4 == 0 ? 4 : esize;
  if (bytes > kMaxRowBytes) {
    pl.threads = kThreads;
    pl.per = 0;
  } else if (pl.edge == 0 && pieces <= 64) {
    pl.threads = pieces <= 16 ? 4 : pieces <= 32 ? 8 : 16;
    pl.per = 4;
  } else {
    int warps = 1;
    while (warps < kWarps && ceil_div(pieces, 32 * warps) > 6) warps *= 2;
    pl.threads = 32 * warps;
    const int need = ceil_div(pieces, pl.threads);
    pl.per = need <= 4 ? 4 : need <= 5 && pl.edge != 2 ? 5 : need <= 6 ? 6 : 8;
  }
  pl.rows = kThreads / pl.threads;
  pl.blocks = ceil_div(M, pl.rows) < kMaxBlocks ? ceil_div(M, pl.rows) : kMaxBlocks;
  return pl;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The sums of v[0..N) over a row's `threads` threads (consecutive lanes, or
// whole warps), in all of them; past a warp through `red` (N floats a warp of
// the block, this call's own: a row's next call of the same stage comes after
// two more of its barriers) behind a barrier of the row's warps alone.
template <int N>
__device__ __forceinline__ void row_sums(float (&v)[N], int threads, float (*red)[kWarps]) {
  const int lanes = threads < 32 ? threads : 32;
  for (int o = lanes / 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (threads <= 32) return;
  const int warps = threads / 32, warp = threadIdx.x / 32, first = warp / warps * warps;
  if (threadIdx.x % 32 == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][warp] = v[i];
  named_barrier(1 + warp / warps, threads);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[i][first + w];
    v[i] = s;
  }
}

// One row's x and dy as held: kPer pieces a thread, a head and a tail unit
template <typename T, int kEdge, int kPer> struct Raw {
  using Edge = typename EdgeUnit<T, kEdge>::type;
  uint4 x[kPer], dy[kPer];
  Edge xh, xt, dh, dt;
};

// shared memory of the first kernel: the rings (kDepth rows of each thread's
// pieces of x and dy, and of its edge words), or, where larger, the block's
// parameter sums (after the rows: [2][D] a warp of narrow rows, or a row
// stream)
template <int kPer>
constexpr int ring_bytes() {
  return kDepth * kThreads * (2 * kPer * 16 + 4 * 4);
}

template <typename T, int kEdge, int kPer>
__global__ void __launch_bounds__(kThreads)
layer_norm_backward_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partials, int M, int D, float eps,
                           int threads) {
  using Un = Unit<T, uint4>;
  using Edge = typename EdgeUnit<T, kEdge>::type;
  using Ed = Unit<T, Edge>;
  constexpr int kE = Un::kE;    // elements of a piece
  constexpr int kEE = Ed::kE;   // elements of an edge unit
  // word edges go through the ring; bf16 rows of odd width (2-byte edges,
  // which cp.async cannot copy) load theirs when the row comes up
  constexpr bool kRingEdges = kEdge == 4;
  // a row's sums: the mean's, the variance's, then (g, g x^) together
  __shared__ float red_mean[1][kWarps], red_var[1][kWarps], red_g[2][kWarps];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);  // [depth][x, dy][kPer][256]
  uint32_t* ring_edges = reinterpret_cast<uint32_t*>(ring + kDepth * 2 * kPer * kThreads);
  float* sums = reinterpret_cast<float*>(smem_raw);  // [adders][2][D], after the rows

  const int t = threadIdx.x % threads, slot = threadIdx.x / threads;
  const int slots = kThreads / threads;
  const long long streams = (long long)gridDim.x * slots;
  const long long first = (long long)blockIdx.x * slots + slot;
  // a warp's streams take as many turns as its first (narrow rows share warps)
  const long long warp_first = (long long)blockIdx.x * slots + threadIdx.x / 32 * 32 / threads;

  // the stream's 16-byte phase, the same for each of its rows: the head's
  // elements, the pieces after it, the tail's first element
  int h = 0;
  if constexpr (kEdge > 0) {
    const size_t off = (size_t)(first < M ? first : 0) * D * sizeof(T);
    h = (int)((16 - off % 16) % 16 / sizeof(T));
    h = h < D ? h : D;
  }
  const int pieces = (D - h) / kE;
  const int tail0 = h + pieces * kE;
  const bool has_head = kEdge > 0 && t < h / kEE;
  const bool has_tail = kEdge > 0 && t < (D - tail0) / kEE;
  auto held = [&](int c) { return t + threads * c < pieces; };
  auto piece0 = [&](int c) { return h + (t + threads * c) * kE; };  // its first element
  auto at = [&](int depth, int a, int c) { return ((depth * 2 + a) * kPer + c) * kThreads + threadIdx.x; };
  auto at_edge = [&](int depth, int k) { return (depth * 4 + k) * kThreads + threadIdx.x; };

  // this thread's part of row `row` into ring slot `depth` (nothing past the
  // last row), one cp.async group either way
  auto issue = [&](long long row, int depth) {
    if (row < M) {
      const size_t off = (size_t)row * D;
      const uint4* xr = reinterpret_cast<const uint4*>(x + off + h);
      const uint4* yr = reinterpret_cast<const uint4*>(dy + off + h);
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        if (held(c)) {
          leaf::cp_async16(ring + at(depth, 0, c), xr + t + threads * c, true);
          leaf::cp_async16(ring + at(depth, 1, c), yr + t + threads * c, true);
        }
      if constexpr (kRingEdges) {
        if (has_head) {
          leaf::cp_async4(ring_edges + at_edge(depth, 0), x + off + t * kEE, true);
          leaf::cp_async4(ring_edges + at_edge(depth, 2), dy + off + t * kEE, true);
        }
        if (has_tail) {
          leaf::cp_async4(ring_edges + at_edge(depth, 1), x + off + tail0 + t * kEE, true);
          leaf::cp_async4(ring_edges + at_edge(depth, 3), dy + off + tail0 + t * kEE, true);
        }
      }
    }
    leaf::cp_async_commit();
  };
  // row `row` from ring slot `depth` into registers
  auto take = [&](Raw<T, kEdge, kPer>& r, long long row, int depth) {
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (held(c)) {
        r.x[c] = ring[at(depth, 0, c)];
        r.dy[c] = ring[at(depth, 1, c)];
      }
    if constexpr (kRingEdges) {
      r.xh = ring_edges[at_edge(depth, 0)];
      r.xt = ring_edges[at_edge(depth, 1)];
      r.dh = ring_edges[at_edge(depth, 2)];
      r.dt = ring_edges[at_edge(depth, 3)];
    } else if (kEdge > 0 && row < M) {
      const size_t off = (size_t)row * D;
      if (has_head) {
        r.xh = reinterpret_cast<const Edge*>(x + off)[t];
        r.dh = reinterpret_cast<const Edge*>(dy + off)[t];
      }
      if (has_tail) {
        r.xt = reinterpret_cast<const Edge*>(x + off + tail0)[t];
        r.dt = reinterpret_cast<const Edge*>(dy + off + tail0)[t];
      }
    }
  };

  const bool params = partials != nullptr;
  float dg[kPer][kE], db[kPer][kE], dgh[kEE], dbh[kEE], dgt[kEE], dbt[kEE];
#pragma unroll
  for (int c = 0; c < kPer; ++c)
#pragma unroll
    for (int e = 0; e < kE; ++e) dg[c][e] = db[c][e] = 0.f;
#pragma unroll
  for (int e = 0; e < kEE; ++e) dgh[e] = dbh[e] = dgt[e] = dbt[e] = 0.f;

  for (int k = 0; k < kDepth - 1; ++k) issue(first + k * streams, k);
  Raw<T, kEdge, kPer> cur = {};
  for (long long turn = 0; warp_first + turn * streams < M; ++turn) {
    const long long row = first + turn * streams;
    // the row kDepth - 1 ahead into the slot the last turn emptied, then
    // this row's own copies landed
    issue(row + (kDepth - 1) * streams, (int)((turn + kDepth - 1) % kDepth));
    leaf::cp_async_wait<kDepth - 1>();
    take(cur, row, (int)(turn % kDepth));

    float f[kE], fh[kEE], ft[kEE];
    float s[1] = {0.f};
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (held(c)) {
        Un::unpack(cur.x[c], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) s[0] += f[e];
      }
    Ed::unpack(cur.xh, fh);
    Ed::unpack(cur.xt, ft);
#pragma unroll
    for (int e = 0; e < kEE; ++e) s[0] += (has_head ? fh[e] : 0.f) + (has_tail ? ft[e] : 0.f);
    row_sums<1>(s, threads, red_mean);
    const float mean = s[0] / D;

    float q[1] = {0.f};
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (held(c)) {
        Un::unpack(cur.x[c], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) q[0] += (f[e] - mean) * (f[e] - mean);
      }
#pragma unroll
    for (int e = 0; e < kEE; ++e) {
      if (has_head) q[0] += (fh[e] - mean) * (fh[e] - mean);
      if (has_tail) q[0] += (ft[e] - mean) * (ft[e] - mean);
    }
    row_sums<1>(q, threads, red_var);
    const float rstd = 1.f / sqrtf(q[0] / D + eps);

    // sum g and g x^; the head and tail units start at multiples of kEE
    float gs[2] = {0.f, 0.f};
    float d[kE], gam[kE], dhh[kEE], dtt[kEE], gh[kEE], gt[kEE];
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (held(c)) {
        Un::unpack(cur.x[c], f);
        Un::unpack(cur.dy[c], d);
        load_params_at<kE>(scale + piece0(c), gam, h);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float g = d[e] * gam[e];
          gs[0] += g;
          gs[1] += g * ((f[e] - mean) * rstd);
        }
      }
    Ed::unpack(cur.dh, dhh);
    Ed::unpack(cur.dt, dtt);
    if (has_head) {
      load_params<kEE>(scale + t * kEE, gh);
#pragma unroll
      for (int e = 0; e < kEE; ++e) {
        gs[0] += dhh[e] * gh[e];
        gs[1] += dhh[e] * gh[e] * ((fh[e] - mean) * rstd);
      }
    }
    if (has_tail) {
      load_params<kEE>(scale + tail0 + t * kEE, gt);
#pragma unroll
      for (int e = 0; e < kEE; ++e) {
        gs[0] += dtt[e] * gt[e];
        gs[1] += dtt[e] * gt[e] * ((ft[e] - mean) * rstd);
      }
    }
    row_sums<2>(gs, threads, red_g);
    const float m1 = gs[0] / D, m2 = gs[1] / D;

    // dx, and the parameters' sums
    if (row < M) {
      const size_t off = (size_t)row * D;
      uint4* dxr = reinterpret_cast<uint4*>(dx + off + h);
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        if (held(c)) {
          Un::unpack(cur.x[c], f);
          Un::unpack(cur.dy[c], d);
          load_params_at<kE>(scale + piece0(c), gam, h);
          float out[kE];
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const float xh = (f[e] - mean) * rstd;
            out[e] = rstd * (d[e] * gam[e] - m1 - xh * m2);
            if (params) {
              dg[c][e] += d[e] * xh;
              db[c][e] += d[e];
            }
          }
          dxr[t + threads * c] = Un::pack(out);
        }
      if (has_head) {
        float out[kEE];
#pragma unroll
        for (int e = 0; e < kEE; ++e) {
          const float xh = (fh[e] - mean) * rstd;
          out[e] = rstd * (dhh[e] * gh[e] - m1 - xh * m2);
          dgh[e] += dhh[e] * xh;
          dbh[e] += dhh[e];
        }
        reinterpret_cast<Edge*>(dx + off)[t] = Ed::pack(out);
      }
      if (has_tail) {
        float out[kEE];
#pragma unroll
        for (int e = 0; e < kEE; ++e) {
          const float xh = (ft[e] - mean) * rstd;
          out[e] = rstd * (dtt[e] * gt[e] - m1 - xh * m2);
          dgt[e] += dtt[e] * xh;
          dbt[e] += dtt[e];
        }
        reinterpret_cast<Edge*>(dx + off + tail0)[t] = Ed::pack(out);
      }
    }
  }
  if (!params) return;

  // the block's sums, one row of partials: narrow rows first add the rows of
  // a warp (lanes t, t + threads, ... hold the same columns) by butterfly;
  // then each warp (narrow) or row stream writes its sums, at its own
  // columns, into a row of `sums` of its own, and each column is added over
  // those rows in order
  if (threads < 32) {
    for (int o = threads; o < 32; o <<= 1) {
#pragma unroll
      for (int c = 0; c < kPer; ++c)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          dg[c][e] += __shfl_xor_sync(0xffffffffu, dg[c][e], o);
          db[c][e] += __shfl_xor_sync(0xffffffffu, db[c][e], o);
        }
    }
  }
  leaf::cp_async_wait<0>();
  __syncthreads();  // every thread is past its rows: the rings are free
  const int adders = threads < 32 ? kWarps : slots;
  float* mine = sums + 2LL * D * (threads < 32 ? threadIdx.x / 32 : slot);
  if (threads >= 32 || threadIdx.x % 32 < threads) {
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      if (held(c))
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          mine[piece0(c) + e] = dg[c][e];
          mine[D + piece0(c) + e] = db[c][e];
        }
#pragma unroll
    for (int e = 0; e < kEE; ++e) {
      if (has_head) {
        mine[t * kEE + e] = dgh[e];
        mine[D + t * kEE + e] = dbh[e];
      }
      if (has_tail) {
        mine[tail0 + t * kEE + e] = dgt[e];
        mine[D + tail0 + t * kEE + e] = dbt[e];
      }
    }
  }
  __syncthreads();
  float* pg = partials + (long long)blockIdx.x * D;
  float* pb = partials + ((long long)gridDim.x + blockIdx.x) * D;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < adders; ++r) {
      a += sums[2LL * D * r + i];
      b += sums[2LL * D * r + D + i];
    }
    pg[i] = a;
    pb[i] = b;
  }
}

// dscale[c] and dbias[c]: the sums of the P partial rows' column c; 8 columns
// a block, 32 streams adding rows s, s + 32, ... in order, then the streams'
// sums in order
__global__ void __launch_bounds__(kThreads)
layer_norm_backward_reduce_kernel(const float* __restrict__ partials,
                                  float* __restrict__ dscale, float* __restrict__ dbias,
                                  int P, int D) {
  __shared__ float red[2][kReduceStreams][kReduceCols];
  const int lane = threadIdx.x % kReduceCols, stream = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + lane;
  float sg = 0.f, sb = 0.f;
  if (c < D)
    for (int p = stream; p < P; p += kReduceStreams) {
      sg += partials[(long long)p * D + c];
      sb += partials[((long long)P + p) * D + c];
    }
  red[0][stream][lane] = sg;
  red[1][stream][lane] = sb;
  __syncthreads();
  if (threadIdx.x < kReduceCols && c < D) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < kReduceStreams; ++s) {
      a += red[0][s][lane];
      b += red[1][s][lane];
    }
    dscale[c] = a;
    dbias[c] = b;
  }
}

struct BwdArgs {
  const void* x;
  const float* scale;
  const void* dy;
  void* dx;
  float* partials;
  int M, D;
  float eps;
  cudaStream_t stream;
};

template <typename T, int kEdge, int kPer>
cudaError_t launch_rows(const BwdPlan& pl, const BwdArgs& a) {
  auto kernel = layer_norm_backward_kernel<T, kEdge, kPer>;
  const int adders = pl.threads <= 32 ? kWarps : kThreads / pl.threads;
  const int sums = a.partials ? adders * 2 * a.D * (int)sizeof(float) : 0;
  const int smem = ring_bytes<kPer>() > sums ? ring_bytes<kPer>() : sums;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<pl.blocks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.scale, static_cast<const T*>(a.dy), static_cast<T*>(a.dx),
      a.partials, a.M, a.D, a.eps, pl.threads);
  return cudaGetLastError();
}

// every `per` that make_plan gives rows with kEdge edges
template <typename T, int kEdge>
cudaError_t launch_edge(const BwdPlan& pl, const BwdArgs& a) {
  switch (pl.per) {
    case 4:
      return launch_rows<T, kEdge, 4>(pl, a);
    case 5:
      if constexpr (kEdge != 2) return launch_rows<T, kEdge, 5>(pl, a);
      return cudaErrorInvalidValue;
    case 6:
      return launch_rows<T, kEdge, 6>(pl, a);
    case 8:
      return launch_rows<T, kEdge, 8>(pl, a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_plan(const BwdPlan& pl, const BwdArgs& a) {
  if (pl.edge == 0) return launch_edge<T, 0>(pl, a);
  if (pl.edge == 4) return launch_edge<T, 4>(pl, a);
  if constexpr (sizeof(T) == 2)
    if (pl.edge == 2) return launch_edge<T, 2>(pl, a);
  return cudaErrorInvalidValue;
}

int element_size(int dtype) {
  return dtype == leaf::kFloat32 ? 4 : dtype == leaf::kBFloat16 ? 2 : 0;
}

}  // namespace

// dx [M, D] (x's dtype) and, where `partials` is not null, dscale and dbias
// [D] (fp32) from x [M, D], the fp32 scale [D] and dy [M, D] (x's dtype, all
// contiguous and 16-byte aligned); `partials` is fp32 scratch [2, blocks, D]
// of the plan's blocks.
extern "C" int leaf_layer_norm_backward(const void* x, const void* scale, const void* dy,
                                        void* dx, void* dscale, void* dbias, void* partials,
                                        int dtype, int M, int D, float eps, int device,
                                        void* stream) {
  const int esize = element_size(dtype);
  if (M <= 0 || D <= 0 || esize == 0) return cudaErrorInvalidValue;
  const BwdPlan pl = make_plan(M, D, esize);
  if (pl.per == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const BwdArgs a = {x, static_cast<const float*>(scale), dy, dx, part, M, D, eps, s};
  err = dtype == leaf::kFloat32 ? launch_plan<float>(pl, a) : launch_plan<bf16>(pl, a);
  if (err != cudaSuccess || part == nullptr) return err;
  layer_norm_backward_reduce_kernel<<<ceil_div(D, kReduceCols), kThreads, 0, s>>>(
      part, static_cast<float*>(dscale), static_cast<float*>(dbias), pl.blocks, D);
  return cudaGetLastError();
}

// The backward kernel's plan for M rows of D elements of `dtype`, computed on
// the host and launching nothing: plan = {threads a row, pieces a thread as
// compiled (0: D is not taken), edge bytes, row streams a block, blocks};
// returns 0, or a CUDA error code.
extern "C" int leaf_layer_norm_backward_plan(int M, int D, int dtype, int* plan) {
  const int esize = element_size(dtype);
  if (M <= 0 || D <= 0 || esize == 0) return cudaErrorInvalidValue;
  const BwdPlan pl = make_plan(M, D, esize);
  const int fields[5] = {pl.threads, pl.per, pl.edge, pl.rows, pl.blocks};
  for (int i = 0; i < 5; ++i) plan[i] = fields[i];
  return 0;
}
