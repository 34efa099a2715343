// The backward of block-diagonal ("packed") multi-head attention on token-major
// qkv, for Hopper.
//
// Replaces: the VJP of leaf_tpu/ops/packed_attention.py::packed_attention and of
// the attention stage of `fused_attention_block` (`_bwd` and `_block_bwd`, which
// hand the XLA reference to `jax.vjp`; XLA compiles and fuses that on the TPU).
// The Pallas file has no backward kernel of its own.
//
// Given qkv [R, L, 3D] (q | k | v column blocks, head h at columns h*d ..
// (h+1)*d of each), the forward's output out [R, L, D] and its gradient
// dout [R, L, D], writes dqkv [R, L, 3D] in the same fused, token-major layout
// (no head transpose), so that it feeds the qkv projection's gradient products
// as it is.  Per (row, head), over the visible pairs of the forward (keys of the
// query's `group_len` block, j <= i when causal):
//   s_ij = q_i . k_j * scale,   P_ij = exp(s_ij - lse_i)       (fp32)
//   delta_i = dO_i . O_i                                       (fp32)
//   dP_ij = dO_i . v_j, rounded to the dtype
//   dS_ij = P_ij (dP_ij - delta_i) scale
//   dV_j = sum_i round(P_ij) dO_i,  dK_j = sum_i dS_ij q_i,  dQ_i = sum_j dS_ij k_j
// with fp32 sums, each result rounded once to the dtype.  The rounding points are
// those of the plain version's autograd (leaf_tpu_torch/ops/packed_attention.py::
// _reference): the probabilities and dP rounded where its casts round them.
//
// The row log-sum-exp lse_i is recomputed here, in a first pass of the dQ
// kernel over the query's keys, and not saved by the forward: the forward kernel
// (attention_mma.cuh) stays as serving runs it, with no output that only
// training reads, and the fused block's backward recomputes the forward's
// intermediates anyway (it saves its inputs alone, as the JAX `_block_fwd`
// does).  The pass costs one more q.k product per visible pair, a fifth of the
// backward's products.
//
// Two kernels, launched in order on the caller's stream:
//   * dQ, a block per (row, head, 64 queries): stages the queries' q and dO,
//     computes delta and, over 64-key chunks of their key range, first lse, then
//     S, dP and dS, and accumulates dQ = dS K; writes dQ, lse and delta;
//   * dK/dV, a block per (row, head, 64 keys): stages the keys' k and v and, over
//     64-query chunks of the queries that see them, reads lse and delta, forms
//     P and dS again and accumulates dV = P^T dO and dK = dS^T Q.
// Each output element has one writer (its query's block, or its key's), every
// sum runs in a fixed order and nothing is atomic: two runs give the same bits.
//
// Both dtypes run the five products on the tensor cores with the forward's
// helpers (attention_mma.cuh, common.cuh), 4 warps a block, a warp a 16-row
// slice of the block's tile, operands staged by `cp.async` and loaded by
// `ldmatrix`.  The score tiles come out of S = Q K^T (or K Q^T) in the
// accumulators' layout, which is (bf16) or is made (fp32) the A operand of
// the next product (dQ = dS K, dV = P^T dO, dK = dS^T Q), whose B operand
// runs along the staged rows.
//   * bf16: `mma.sync.m16n8k16`, fp32 accumulators; B by `ldmatrix.trans`.
//     P^T feeds dV rounded to bf16, the reference's own rounding of P; dS,
//     fp32 in the reference, is split into two bf16 terms hi + lo (16
//     significant bits) that feed dQ and dK as two products each.
//   * fp32: `mma.sync.m16n8k8` TF32 with every operand split into hi + lo
//     (3xTF32, fp32 accuracy, as the forward); a score tile's A columns t and
//     t + 4 are its keys 2t and 2t + 1, so B comes by word loads of the staged
//     rows 2t and 2t + 1 (`ldmatrix` cannot transpose 32-bit words).
// 16-row steps that no row of a warp's slice can see, and steps past a
// tile's end, are skipped: the last token of a 257-token row costs one step,
// not a 64-row tile.  Heads are computed at 32, 64, 80, 96 or 128 columns
// (ViT-H's 80 at its width).
//
// What bounds it on the H100: five products of L x L x d per (row, head)
// against 2 reads of qkv and out and one write of dqkv: at the training
// shapes (L 50-257, d 64-80) bf16 sits near the line between the two (989
// TFLOP/s, 3.35 TB/s) and fp32, at a third of the TF32 rate (165 TFLOP/s), is
// bound by its operations.
#include "attention_mma.cuh"

namespace {

constexpr int kTile = 64;                 // rows of a block's own tile and of a chunk
constexpr int kMaxHeadDim = 128;
constexpr float kNegBig = -1e30f;         // running max before any visible key

struct BwdArgs {
  const void* qkv;
  const void* out;
  const void* dout;
  void* dqkv;
  float* lse;    // [R, H, L], base 2 (of the logits times log2 e)
  float* delta;  // [R, H, L]
  int R, L, H, d, group_len, causal;
  float scale;
};

inline __host__ __device__ int imin(int a, int b) { return a < b ? a : b; }
inline __host__ __device__ int imax(int a, int b) { return a > b ? a : b; }

// keys [k0, k1) that queries [q0, q1) of a row may see
inline __host__ __device__ void key_range(int q0, int q1, int L, int g, int causal, int& k0,
                                          int& k1) {
  k0 = q0 / g * g;
  k1 = imin(((q1 - 1) / g + 1) * g, L);
  if (causal) k1 = imin(k1, q1);
}

// queries [i0, i1) of a row that see keys [k0, k1)
inline __host__ __device__ void query_range(int k0, int k1, int L, int g, int causal,
                                            int& i0, int& i1) {
  i0 = k0 / g * g;
  i1 = imin(((k1 - 1) / g + 1) * g, L);
  if (causal) i0 = imax(i0, k0);
}

__device__ __forceinline__ bool visible(int i, int j, int g, int causal) {
  return i / g == j / g && (!causal || j <= i);
}

// the block's (row, head, tile) from a flat grid: tiles fastest, then heads
struct Place {
  int r, h, tile;
};
__device__ __forceinline__ Place place(const BwdArgs& p) {
  const int tiles = (p.L + kTile - 1) / kTile;
  const int flat = blockIdx.x;
  return {flat / (tiles * p.H), flat / tiles % p.H, flat % tiles};
}

// delta_i = dO_i . O_i of the tile's n rows into delta[kTile] (0 past n), a
// warp a row, read from device memory
template <typename T>
__device__ __forceinline__ void row_deltas(float* delta, const T* __restrict__ dO,
                                           const T* __restrict__ o, long long stride, int n,
                                           int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  for (int i = warp; i < kTile; i += warps) {
    float s = 0.f;
    if (i < n)
      for (int c = lane; c < d; c += 32)
        s = fmaf(leaf::to_float(dO[i * stride + c]), leaf::to_float(o[i * stride + c]), s);
    s = leaf::warp_sum(s);
    if (lane == 0) delta[i] = s;
  }
}

// ===========================================================================
// Tensor-core kernels, 4 warps a block, a warp 16 rows of the tile: bf16
// products as `mma.sync.m16n8k16`, fp32 ones as three TF32 `m16n8k8`
// products of operands split into hi + lo (3xTF32)
// ===========================================================================

namespace tc {

using leaf::mma::bf16;
constexpr int kWarps = kTile / 16;
constexpr int kThreads = 32 * kWarps;

// elements past a staged row: its stride is 4 words mod 8 (fp32) or 16 bytes
// past a multiple of 128 (bf16), which keeps `ldmatrix` and fp32's column
// loads free of bank conflicts
template <typename T> __host__ __device__ constexpr int pad() { return sizeof(T) == 2 ? 8 : 4; }

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return 4 * kTile * (DP + pad<T>()) * sizeof(T) + 2 * kTile * sizeof(float);
}

// rows [0, kTile) of a token-major matrix (row stride `stride`, d columns
// from src) into shared rows of DP + pad, by cp.async; zeros past n rows and
// d columns.  The caller commits and waits.
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long stride, int n,
                                      int d) {
  leaf::mma::stage_rows<DP>(dst, src, stride, 0, kTile, n, d);
}
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride, int n,
                                      int d) {
  leaf::mma::stage_rows_f32<DP>(dst, src, stride, 0, kTile, n, d,
                                d % 4 == 0 && stride % 4 == 0);
}

// ldmatrix addresses of this lane inside a 16-row block: the A operand by
// lane % 16, B from rows stored [n][k] by 8 * (lane / 16); columns in
// elements (a 16 x 16 bf16 block, a 16 x 8 fp32 one)
struct Lanes {
  int a_row, a_col, b_row, b_col;
};
template <typename T>
__device__ __forceinline__ Lanes lanes(int lane) {
  constexpr int kHalf = sizeof(T) == 2 ? 8 : 4;
  return {lane % 8 + 8 * ((lane / 8) % 2), kHalf * (lane / 16), lane % 8 + 8 * (lane / 16),
          kHalf * ((lane / 8) % 2)};
}

// c (16 rows x 16 columns as two m16n8 accumulators) = A[16][DP] . B[16][DP]^T,
// the 16 rows of each at A and B (staged rows)
template <int DP>
__device__ __forceinline__ void scores(float (&c)[2][4], const bf16* A, const bf16* B,
                                       const Lanes& ln) {
  constexpr int kStride = DP + pad<bf16>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], b[4];
    leaf::ldmatrix_x4(a, A + ln.a_row * kStride + kk * 16 + ln.a_col);
    leaf::ldmatrix_x4(b, B + ln.b_row * kStride + kk * 16 + ln.b_col);
    leaf::mma::mma_16816(c[0], a, b[0], b[1]);
    leaf::mma::mma_16816(c[1], a, b[2], b[3]);
  }
}
template <int DP>
__device__ __forceinline__ void scores(float (&c)[2][4], const float* A, const float* B,
                                       const Lanes& ln) {
  constexpr int kStride = DP + pad<float>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t a[4], ah[4], al[4], b[4], bh[4], bl[4];
    leaf::ldmatrix_x4(a, A + ln.a_row * kStride + kk * 8 + ln.a_col);
    leaf::ldmatrix_x4(b, B + ln.b_row * kStride + kk * 8 + ln.b_col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      leaf::split_tf32(__uint_as_float(a[e]), ah[e], al[e]);
      leaf::split_tf32(__uint_as_float(b[e]), bh[e], bl[e]);
    }
    leaf::mma_3xtf32(c[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
    leaf::mma_3xtf32(c[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
  }
}

// the A fragment (16 x 16, bf16) of a score tile held as two m16n8 accumulators
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = leaf::mma::pack_bf16(c[0][0], c[0][1]);
  a[1] = leaf::mma::pack_bf16(c[0][2], c[0][3]);
  a[2] = leaf::mma::pack_bf16(c[1][0], c[1][1]);
  a[3] = leaf::mma::pack_bf16(c[1][2], c[1][3]);
}

// acc[DP / 8] (16 rows x DP) += W (the 16 x 16 score tile c) . S[16][DP], S's
// 16 rows stored [k][n] at S.  bf16: W as the A operand in bf16, rounded
// (kSplit false: P, as the reference rounds it) or as hi + lo, two products
// (kSplit: dS, fp32 in the reference); fp32: every operand split, 3xTF32.
template <int DP, bool kSplit>
__device__ __forceinline__ void product(float (&acc)[DP / 8][4], const float (&c)[2][4],
                                        const bf16* S, const Lanes& ln, int lane) {
  constexpr int kStride = DP + pad<bf16>();
  uint32_t hi[4], lo[4];
  a_fragment(hi, c);
  if (kSplit) {
    float r[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) r[h][e] = c[h][e] - leaf::round_to<bf16>(c[h][e]);
    a_fragment(lo, r);
  }
#pragma unroll
  for (int nn = 0; nn < DP / 16; ++nn) {
    uint32_t b[4];
    leaf::mma::ldmatrix_x4_trans(b, S + ln.a_row * kStride + nn * 16 + ln.a_col);
    if (kSplit) {
      leaf::mma::mma_16816(acc[2 * nn], lo, b[0], b[1]);
      leaf::mma::mma_16816(acc[2 * nn + 1], lo, b[2], b[3]);
    }
    leaf::mma::mma_16816(acc[2 * nn], hi, b[0], b[1]);
    leaf::mma::mma_16816(acc[2 * nn + 1], hi, b[2], b[3]);
  }
}
// fp32: two k8 steps (the tile's keys 0-7 and 8-15); the A columns t and
// t + 4 of a step are its keys 2t and 2t + 1, which this lane holds as (c0,
// c2) and (c1, c3), so S's rows 2t and 2t + 1 give B (the forward's PV)
template <int DP, bool kSplit>
__device__ __forceinline__ void product(float (&acc)[DP / 8][4], const float (&c)[2][4],
                                        const float* S, const Lanes& ln, int lane) {
  constexpr int kStride = DP + pad<float>();
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t ah[4], al[4];
    leaf::split_tf32(c[j][0], ah[0], al[0]);
    leaf::split_tf32(c[j][2], ah[1], al[1]);
    leaf::split_tf32(c[j][1], ah[2], al[2]);
    leaf::split_tf32(c[j][3], ah[3], al[3]);
    const float* s = S + (8 * j + 2 * t) * kStride + g;
#pragma unroll
    for (int nn = 0; nn < DP / 8; ++nn) {
      uint32_t bh0, bl0, bh1, bl1;
      leaf::split_tf32(s[nn * 8], bh0, bl0);
      leaf::split_tf32(s[kStride + nn * 8], bh1, bl1);
      leaf::mma_3xtf32(acc[nn], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// rows g and g + 8 of a warp's 16 (those below n) of acc into the token-major
// dst (row stride `stride`), columns below d
__device__ __forceinline__ void store_pair(bf16* p, float a, float b, bool both) {
  *reinterpret_cast<uint32_t*>(p) = leaf::mma::pack_bf16(a, b);  // d is even
}
__device__ __forceinline__ void store_pair(float* p, float a, float b, bool both) {
  p[0] = a;
  if (both) p[1] = b;
}
template <typename T, int DP>
__device__ __forceinline__ void store(T* dst, const float (&acc)[DP / 8][4], int row0, int n,
                                      long long stride, int d, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < d)
        store_pair(dst + row * stride + col, acc[j][2 * r], acc[j][2 * r + 1], col + 1 < d);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
attention_backward_dq_kernel(const BwdArgs p) {
  constexpr int kStride = DP + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kTile * kStride;
  T* Ks = dOs + kTile * kStride;
  T* Vs = Ks + kTile * kStride;
  float* delta_s = reinterpret_cast<float*>(Vs + kTile * kStride);

  const Place pl = place(p);
  const int q0 = pl.tile * kTile, q1 = imin(q0 + kTile, p.L), n = q1 - q0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int gl = p.group_len;
  const long long D = (long long)p.H * p.d;
  const long long tok0 = (long long)pl.r * p.L;
  const T* q = static_cast<const T*>(p.qkv) + tok0 * 3 * D + (long long)pl.h * p.d;
  const T* k = q + D;
  const T* v = q + 2 * D;
  const T* o = static_cast<const T*>(p.out) + tok0 * D + (long long)pl.h * p.d;
  const T* dO = static_cast<const T*>(p.dout) + tok0 * D + (long long)pl.h * p.d;
  const long long stat0 = ((long long)pl.r * p.H + pl.h) * p.L;
  const float scale_log2e = p.scale * 1.4426950408889634f;
  const Lanes ln = lanes<T>(lane);

  stage<DP>(Qs, q + q0 * 3 * D, 3 * D, n, p.d);
  stage<DP>(dOs, dO + q0 * D, D, n, p.d);
  leaf::cp_async_commit();
  row_deltas(delta_s, dO + q0 * D, o + q0 * D, D, n, p.d);

  // the warp's 16 queries, the keys they see, and this lane's two rows
  const int wq0 = q0 + 16 * warp, wq1 = imin(wq0 + 16, q1);
  const bool active = wq0 < q1;
  int k0, k1, wk0 = 0, wk1 = 0;
  key_range(q0, q1, p.L, gl, p.causal, k0, k1);
  if (active) key_range(wq0, wq1, p.L, gl, p.causal, wk0, wk1);
  const int qi[2] = {wq0 + g, wq0 + g + 8};
  const T* Qw = Qs + 16 * warp * kStride;
  const T* dOw = dOs + 16 * warp * kStride;

  // pass 1: each query's log-sum-exp (base 2) over its visible keys
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  for (int kc = k0; kc < k1; kc += kTile) {
    const int nk = imin(kTile, k1 - kc);
    __syncthreads();
    stage<DP>(Ks, k + kc * 3 * D, 3 * D, nk, p.d);
    leaf::cp_async_commit();
    leaf::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int j2 = 0; j2 < 4; ++j2) {
      const int ks0 = kc + 16 * j2;
      if (ks0 >= kc + nk || ks0 >= wk1 || ks0 + 16 <= wk0) continue;
      float s[2][4];
      scores<DP>(s, Qw, Ks + 16 * j2 * kStride, ln);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = ks0 + 8 * h + 2 * t + (e & 1), r = e >> 1;
          if (qi[r] < q1 && kj < k1 && visible(qi[r], kj, gl, p.causal)) {
            const float x = s[h][e] * scale_log2e;
            const float mn = fmaxf(m[r], x);
            l[r] = l[r] * exp2f(m[r] - mn) + exp2f(x - mn);
            m[r] = mn;
          }
        }
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad hold a row
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], m2);
      l[r] = l[r] * exp2f(m[r] - mn) + l2 * exp2f(m2 - mn);
      m[r] = mn;
    }
    lse[r] = m[r] + log2f(l[r]);  // every query sees itself: l > 0
    delta[r] = delta_s[16 * warp + g + 8 * r];
    if (t == 0 && qi[r] < q1) {
      p.lse[stat0 + qi[r]] = lse[r];
      p.delta[stat0 + qi[r]] = delta[r];
    }
  }

  // pass 2: dS over the same keys, dQ += dS K
  float dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int kc = k0; kc < k1; kc += kTile) {
    const int nk = imin(kTile, k1 - kc);
    __syncthreads();
    stage<DP>(Ks, k + kc * 3 * D, 3 * D, nk, p.d);
    stage<DP>(Vs, v + kc * 3 * D, 3 * D, nk, p.d);
    leaf::cp_async_commit();
    leaf::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int j2 = 0; j2 < 4; ++j2) {
      const int ks0 = kc + 16 * j2;
      if (ks0 >= kc + nk || ks0 >= wk1 || ks0 + 16 <= wk0) continue;
      float s[2][4], dp[2][4];
      scores<DP>(s, Qw, Ks + 16 * j2 * kStride, ln);
      scores<DP>(dp, dOw, Vs + 16 * j2 * kStride, ln);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = ks0 + 8 * h + 2 * t + (e & 1), r = e >> 1;
          float ds = 0.f;
          if (qi[r] < q1 && kj < k1 && visible(qi[r], kj, gl, p.causal)) {
            const float pr = exp2f(s[h][e] * scale_log2e - lse[r]);
            ds = pr * (leaf::round_to<T>(dp[h][e]) - delta[r]) * p.scale;
          }
          s[h][e] = ds;
        }
      product<DP, true>(dq, s, Ks + 16 * j2 * kStride, ln, lane);
    }
  }
  if (active)
    store<T, DP>(static_cast<T*>(p.dqkv) + (tok0 + q0) * 3 * D + (long long)pl.h * p.d, dq,
                 16 * warp, n, 3 * D, p.d, lane);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
attention_backward_dkv_kernel(const BwdArgs p) {
  constexpr int kStride = DP + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kTile * kStride;
  T* Qs = Vs + kTile * kStride;
  T* dOs = Qs + kTile * kStride;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * kStride);
  float* delta_s = lse_s + kTile;

  const Place pl = place(p);
  const int k0 = pl.tile * kTile, k1 = imin(k0 + kTile, p.L), nk = k1 - k0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int gl = p.group_len;
  const long long D = (long long)p.H * p.d;
  const long long tok0 = (long long)pl.r * p.L;
  const T* q = static_cast<const T*>(p.qkv) + tok0 * 3 * D + (long long)pl.h * p.d;
  const T* k = q + D;
  const T* v = q + 2 * D;
  const T* dO = static_cast<const T*>(p.dout) + tok0 * D + (long long)pl.h * p.d;
  const long long stat0 = ((long long)pl.r * p.H + pl.h) * p.L;
  const float scale_log2e = p.scale * 1.4426950408889634f;
  const Lanes ln = lanes<T>(lane);

  stage<DP>(Ks, k + k0 * 3 * D, 3 * D, nk, p.d);
  stage<DP>(Vs, v + k0 * 3 * D, 3 * D, nk, p.d);
  leaf::cp_async_commit();

  // the warp's 16 keys, the queries that see them, and this lane's two rows
  const int wk0 = k0 + 16 * warp, wk1 = imin(wk0 + 16, k1);
  const bool active = wk0 < k1;
  int i0, i1, wi0 = 0, wi1 = 0;
  query_range(k0, k1, p.L, gl, p.causal, i0, i1);
  if (active) query_range(wk0, wk1, p.L, gl, p.causal, wi0, wi1);
  const int kj[2] = {wk0 + g, wk0 + g + 8};
  const T* Kw = Ks + 16 * warp * kStride;
  const T* Vw = Vs + 16 * warp * kStride;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int qc = i0; qc < i1; qc += kTile) {
    const int nq = imin(kTile, i1 - qc);
    __syncthreads();
    stage<DP>(Qs, q + qc * 3 * D, 3 * D, nq, p.d);
    stage<DP>(dOs, dO + qc * D, D, nq, p.d);
    leaf::cp_async_commit();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      lse_s[i] = i < nq ? p.lse[stat0 + qc + i] : 0.f;
      delta_s[i] = i < nq ? p.delta[stat0 + qc + i] : 0.f;
    }
    leaf::cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    for (int j2 = 0; j2 < 4; ++j2) {
      const int qs0 = qc + 16 * j2;
      if (qs0 >= qc + nq || qs0 >= wi1 || qs0 + 16 <= wi0) continue;
      float s[2][4], dp[2][4];  // [key g (+8)][query]
      scores<DP>(s, Kw, Qs + 16 * j2 * kStride, ln);
      scores<DP>(dp, Vw, dOs + 16 * j2 * kStride, ln);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * j2 + 8 * h + 2 * t + (e & 1), i = qc + col, r = e >> 1;
          float pr = 0.f, ds = 0.f;
          if (i < i1 && kj[r] < k1 && visible(i, kj[r], gl, p.causal)) {
            pr = exp2f(s[h][e] * scale_log2e - lse_s[col]);
            ds = pr * (leaf::round_to<T>(dp[h][e]) - delta_s[col]) * p.scale;
          }
          s[h][e] = pr;
          dp[h][e] = ds;
        }
      product<DP, false>(dv, s, dOs + 16 * j2 * kStride, ln, lane);
      product<DP, true>(dk, dp, Qs + 16 * j2 * kStride, ln, lane);
    }
  }
  if (active) {
    T* base = static_cast<T*>(p.dqkv) + (tok0 + k0) * 3 * D + (long long)pl.h * p.d;
    store<T, DP>(base + D, dk, 16 * warp, nk, 3 * D, p.d, lane);
    store<T, DP>(base + 2 * D, dv, 16 * warp, nk, 3 * D, p.d, lane);
  }
}

template <typename T, int DP>
cudaError_t launch_width(const BwdArgs& p, cudaStream_t stream) {
  auto dq = attention_backward_dq_kernel<T, DP>;
  auto dkv = attention_backward_dkv_kernel<T, DP>;
  constexpr int bytes = (int)smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(((long long)p.L + kTile - 1) / kTile * p.H * p.R);
  dq<<<blocks, kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv<<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// DP: the head width rounded up to 32, 64, 80, 96 or 128 (ViT-H's heads of 80
// at their width)
template <typename T>
cudaError_t launch(const BwdArgs& p, cudaStream_t stream) {
  if (sizeof(T) == 2 && p.d % 8) return cudaErrorInvalidValue;  // 16-byte pieces
  if (p.d <= 32) return launch_width<T, 32>(p, stream);
  if (p.d <= 64) return launch_width<T, 64>(p, stream);
  if (p.d <= 80) return launch_width<T, 80>(p, stream);
  if (p.d <= 96) return launch_width<T, 96>(p, stream);
  return launch_width<T, 128>(p, stream);
}

}  // namespace tc

}  // namespace

// dqkv [R, L, 3D] from qkv [R, L, 3D], the forward's out and its gradient dout
// [R, L, D] (all of `dtype`, contiguous, 16-byte aligned; bf16 heads a multiple
// of 8 wide); `stats` is fp32 scratch [2, R, H, L] (each query's log-sum-exp,
// then delta), written by the first kernel and read by the second.
extern "C" int leaf_packed_attention_backward(const void* qkv, const void* out,
                                              const void* dout, void* dqkv, void* stats,
                                              int dtype, int R, int L, int n_heads,
                                              int head_dim, int group_len, int causal,
                                              float scale, int device, void* stream) {
  if (R <= 0 || L <= 0 || n_heads <= 0 || head_dim <= 0 || head_dim > kMaxHeadDim ||
      group_len <= 0)
    return cudaErrorInvalidValue;
  if (((long long)L + kTile - 1) / kTile * n_heads * R > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  float* lse = static_cast<float*>(stats);
  const BwdArgs p = {qkv,  out, dout, dqkv,      lse,    lse + (long long)R * n_heads * L,
                     R,    L,   n_heads, head_dim, group_len, causal,
                     scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case leaf::kFloat32:
      return tc::launch<float>(p, s);
    case leaf::kBFloat16:
      return tc::launch<__nv_bfloat16>(p, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward's schedule for one row of L tokens, computed on the host and
// launching nothing: `ranges` receives, for each 64-query tile of the dQ kernel,
// {q0, q1, k0, k1} (its queries and the keys it visits), then for each 64-key
// tile of the dK/dV kernel {k0, k1, i0, i1}; returns the number of tiles of one
// kernel, or -1 if 8 x that is more than `cap`.
extern "C" int leaf_attention_backward_schedule(int L, int group_len, int causal,
                                                int* ranges, int cap) {
  if (L <= 0 || group_len <= 0) return -1;
  const int tiles = (L + kTile - 1) / kTile;
  if (8 * tiles > cap) return -1;
  for (int t = 0; t < tiles; ++t) {
    const int a0 = t * kTile, a1 = imin(a0 + kTile, L);
    int* dq = ranges + 4 * t;
    int* dkv = ranges + 4 * (tiles + t);
    dq[0] = dkv[0] = a0;
    dq[1] = dkv[1] = a1;
    key_range(a0, a1, L, group_len, causal, dq[2], dq[3]);
    query_range(a0, a1, L, group_len, causal, dkv[2], dkv[3]);
  }
  return tiles;
}
