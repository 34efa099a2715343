// The backward of block-diagonal ("packed") multi-head attention on token-major
// qkv, for Hopper.
//
// Replaces: the VJP of leaf_tpu/ops/packed_attention.py::packed_attention and of
// the attention stage of `fused_attention_block` (`_bwd` and `_block_bwd`, which
// hand the XLA reference to `jax.vjp`; XLA compiles and fuses that on the TPU).
// The Pallas file has no backward kernel of its own.
//
// Given qkv [R, L, 3D] (q | k | v column blocks, head h at columns h*d ..
// (h+1)*d of each), the forward's output out [R, L, D], its gradient dout
// [R, L, D] and each query's log-sum-exp lse [R, H, L] (natural log, fp32: the
// forward kernel writes it where training asks for it, attention_mma.cuh),
// writes dqkv [R, L, 3D] in the same fused, token-major layout (no head
// transpose), so that it feeds the qkv projection's gradient products as it
// is.  Per (row, head), over the visible pairs of the forward (keys of the
// query's `group_len` block, j <= i when causal):
//   s_ij = q_i . k_j * scale,   P_ij = exp(s_ij - lse_i)       (fp32)
//   delta_i = dO_i . O_i                                       (fp32)
//   dP_ij = dO_i . v_j, rounded to the dtype
//   dS_ij = P_ij (dP_ij scale - delta_i scale)             (one fused multiply-add)
//   dV_j = sum_i round(P_ij) dO_i,  dK_j = sum_i dS_ij q_i,  dQ_i = sum_j dS_ij k_j
// with fp32 sums, each result rounded once to the dtype.  The rounding points are
// those of the plain version's autograd (leaf_tpu_torch/ops/packed_attention.py::
// _reference): the probabilities and dP rounded where its casts round them.
//
// Two kernels, launched in order on the caller's stream:
//   * dQ, a block per (row, head, up to 6 tiles of 16 queries), a warp a tile:
//     delta of its queries (written for the second kernel), then, over the
//     keys its queries see, S, dP and dS, and dQ += dS K;
//   * dK/dV, a block per (row, head, up to 6 tiles of 16 keys), a warp a tile:
//     over the queries that see its keys, P and dS again from the saved lse and
//     delta, dV += P^T dO and dK += dS^T Q.
// Each output element has one writer (its query's warp, or its key's), every
// sum runs in a fixed order and nothing is atomic: two runs give the same bits.
//
// What bounds it on the H100: five products of L x L x d per (row, head)
// against a read of qkv, out, dout and the lse and a write of dqkv: at the
// training shapes (L 50-257, d 64-80) bf16 sits below the tensor cores' ratio
// of operations to bytes (its bound is the bytes) and fp32, at a third of the
// TF32 rate (165 TFLOP/s), is bound by its operations.  The kernels compute
// S and dP twice (once in each kernel) and, in bf16, dS as two terms, ~1.8x
// the products the function needs, and stage the other operand from the L2
// cache once per block.  At the FARE shape (1.37 ms, chip_smoke.py (c))
// they run ~155 TFLOP/s of products (26,010 m16n8k16 a (row, head)): what
// holds them is latency, each warp's step a chain of products,
// exponentials and products again, with 12 warps an SM to hide it.
//
// Design.
//   * The log-sum-exp comes from the forward: the dQ kernel makes one pass
//     over its keys, not two.
//   * Tiles (make_plan): a row's L tokens are 16-row tiles, split into the
//     fewest blocks of at most 6 tiles, evenly: 257 tokens are 3 blocks of 6
//     warps, the last token one warp's tile, not a block's.  Registers are
//     capped for two such blocks an SM (kMinBlocks).
//   * Staging: a block's range of the other operand (the keys and values its
//     queries see in dQ; the queries, dO, lse and delta that see its keys in
//     dK/dV), padded rows as the forward's, goes to shared memory in 64-row
//     chunks.  A range of at most 352 bf16 or 144 fp32 rows (the forward's
//     limits: 227 KB at d = 128) is staged whole and waited for once, as the
//     forward does: after one barrier the warps run free of each other, and
//     the copies overlap the other blocks' products (an SM holds two).  A
//     longer range (SO400M's 729 tokens) goes through a ring of two chunks,
//     the copy of chunk c + 1 overlapping the products of chunk c.
//     `max_whole` (the C entry) lowers the limit, to time the ring against
//     staging whole (chip_smoke.py (c): the ring a little slower at the
//     FARE shape); a wait for each chunk in turn, its products starting
//     while the later chunks were in flight at a barrier a chunk, was
//     slower than waiting once.
//   * A warp's own 16 rows (Q and dO in dQ, K and V in dK/dV) are read once,
//     from device memory straight into the A fragments of the products,
//     before the chunk loop.  fp32 holds them split into hi + lo where that
//     fits the registers (dQ up to 64 columns, dK/dV up to 32, whose
//     accumulators are twice dQ's), else whole, split at each use; the widest
//     fp32 heads (96, 128) and bf16's dK/dV at 128 read them from the L1
//     cache at each use (FragMode).  The score tiles come out of S = Q K^T (or
//     K Q^T) in the accumulators' layout, which is (bf16) or is made (fp32)
//     the A operand of the next product (dQ = dS K, dV = P^T dO, dK = dS^T Q),
//     whose B operand runs along the staged rows.
//   * bf16: `mma.sync.m16n8k16`, fp32 accumulators; B by `ldmatrix` (`.trans`
//     along the staged rows).  P^T feeds dV rounded to bf16, the reference's
//     own rounding of P; dS, fp32 in the reference, is split into two bf16
//     terms hi + lo (16 significant bits) that feed dQ and dK as two products
//     each.  Two 16-row steps a turn of a warp's loop, their products
//     interleaved, were slower.
//   * fp32: `mma.sync.m16n8k8` TF32 with every operand split into hi + lo
//     (3xTF32, fp32 accuracy, as the forward); a score tile's A columns t and
//     t + 4 are its keys 2t and 2t + 1, so B comes by word loads of the staged
//     rows 2t and 2t + 1 (`ldmatrix` cannot transpose 32-bit words).
//   * Masks are index arithmetic: a 16-row step that no row of the warp's tile
//     can see is skipped, one that every row sees entirely runs without
//     per-element tests, ragged edges are zero in shared memory and in the
//     fragments.  Heads are computed at 32, 64, 80, 96 or 128 columns (ViT-H's
//     80 at its width).
// `leaf_attention_backward_schedule` gives the plan and the blocks' ranges;
// ops/packed_attention.py::backward_schedule mirrors it in Python.
#include "attention_mma.cuh"

namespace {

using leaf::mma::bf16;

constexpr int kRows = 16;          // rows of a warp's tile: one mma tile
constexpr int kChunk = 64;         // rows of a staged chunk, and of a ring stage
constexpr int kMaxWhole = 352;     // bf16 rows a block stages whole, at most
constexpr int kMaxWholeF32 = 144;  // fp32 rows
constexpr int kMaxHeadDim = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* qkv;
  const void* out;
  const void* dout;
  void* dqkv;
  const float* lse;  // [R, H, L], natural log: the forward's
  float* delta;      // [R, H, L]: written by the dQ kernel, read by dK/dV
  int R, L, H, d, group_len, causal;
  int warps, blocks;  // tiles a block, blocks a (row, head)
  int whole;          // rows a block stages whole (a multiple of 16); 0: the ring
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

// The plan for one row of L tokens: `warps` 16-row tiles a block, `blocks` a
// (row, head), the same in both kernels; rows each kernel stages whole (its
// blocks' widest range rounded up to 16), or 0 where that is more than
// `max_whole`: the ring.
struct Plan {
  int warps, blocks, dq_whole, dkv_whole;
};

// The kernels' shape: at most kMaxWarps tiles a block, and registers for
// kMinBlocks such blocks an SM: 6 x 2 (at most 168 registers a thread, 12
// warps an SM) ran the FARE shape faster than 8 x 1 (one block an SM, the
// warps' chains of products exposed) and than 4 x 3 down to 2 x 8 (each
// block copies the whole range of the other operand, so the copies grow as
// the blocks shrink); ops/packed_attention.py::BWD_MAX_WARPS is kMaxWarps.
constexpr int kMaxWarps = 6;
constexpr int kMinBlocks = 2;

inline Plan make_plan(int L, int g, int causal, int max_whole) {
  Plan pl;
  const int tiles = (L + kRows - 1) / kRows;
  pl.blocks = (tiles + kMaxWarps - 1) / kMaxWarps;
  pl.warps = (tiles + pl.blocks - 1) / pl.blocks;
  int keys = 0, queries = 0;  // the widest ranges
  for (int a0 = 0; a0 < L; a0 += pl.warps * kRows) {
    const int a1 = imin(a0 + pl.warps * kRows, L);
    int b0, b1;
    key_range(a0, a1, L, g, causal, b0, b1);
    keys = imax(keys, b1 - b0);
    query_range(a0, a1, L, g, causal, b0, b1);
    queries = imax(queries, b1 - b0);
  }
  keys = (keys + 15) & ~15;
  queries = (queries + 15) & ~15;
  pl.dq_whole = keys <= max_whole ? keys : 0;
  pl.dkv_whole = queries <= max_whole ? queries : 0;
  return pl;
}

// A block's own rows [a0, a1) (queries in dQ, keys in dK/dV) of row r, head h,
// and the range [b0, b1) of the other operand they meet; blockIdx.x counts the
// blocks of a (row, head) fastest, then heads.
struct Span {
  int r, h, a0, a1, b0, b1;
};
template <bool kKeys>
__device__ __forceinline__ Span block_span(const BwdArgs& p) {
  Span s;
  const int flat = blockIdx.x;
  s.r = flat / (p.blocks * p.H);
  s.h = flat / p.blocks % p.H;
  s.a0 = flat % p.blocks * p.warps * kRows;
  s.a1 = imin(s.a0 + p.warps * kRows, p.L);
  if (kKeys)
    query_range(s.a0, s.a1, p.L, p.group_len, p.causal, s.b0, s.b1);
  else
    key_range(s.a0, s.a1, p.L, p.group_len, p.causal, s.b0, s.b1);
  return s;
}

// elements past a staged row: its stride is 4 words mod 8 (fp32) or 16 bytes
// past a multiple of 128 (bf16), which keeps `ldmatrix` and fp32's column
// loads free of bank conflicts
template <typename T> __host__ __device__ constexpr int pad() { return sizeof(T) == 2 ? 8 : 4; }

// `rows` rows from row0 of a token-major matrix (row stride `stride`, d
// columns from src) into shared rows of DP + pad, by cp.async; zeros at and
// past row_end and d.  The caller commits.
template <int DP>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long stride, int row0,
                                      int rows, int row_end, int d) {
  leaf::mma::stage_rows<DP>(dst, src, stride, row0, rows, row_end, d);
}
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride, int row0,
                                      int rows, int row_end, int d) {
  leaf::mma::stage_rows_f32<DP>(dst, src, stride, row0, rows, row_end, d,
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

// ---------------------------------------------------------------------------
// A warp's own 16 rows as the A fragments of its products (g = lane / 4,
// t = lane % 4): bf16 m16k16 fragments, k-step kk, words (row g, columns 16
// kk + 2t, + 1), (g + 8, same), (g, + 8), (g + 8, + 8); fp32 m16k8 ones, (g,
// 8 kk + t), (g + 8, same), (g, + 4), (g + 8, + 4).  Zeros past n rows and d
// columns.
// ---------------------------------------------------------------------------

enum FragMode { kHeld, kHeldSplit, kReload };

__device__ __forceinline__ int frag_row(int lane, int e) { return lane / 4 + 8 * (e & 1); }
template <typename T>
__device__ __forceinline__ int frag_col(int lane, int kk, int e) {
  return sizeof(T) == 2 ? 16 * kk + 2 * (lane % 4) + 8 * (e >> 1)
                        : 8 * kk + lane % 4 + 4 * (e >> 1);
}
// word e of k-step kk (a bf16 pair, or one fp32 value's bits)
template <typename T>
__device__ __forceinline__ uint32_t frag_word(const T* rows, long long stride, int n, int d,
                                              int lane, int kk, int e) {
  const int row = frag_row(lane, e), col = frag_col<T>(lane, kk, e);
  if (row >= n || col >= d) return 0u;
  return __ldg(reinterpret_cast<const unsigned int*>(rows + row * stride + col));
}

template <typename T, int DP, int kMode> struct Frag;

template <int DP> struct Frag<bf16, DP, kHeld> {
  uint32_t a[DP / 16][4];
  __device__ __forceinline__ void load(const bf16* rows, long long stride, int n, int d,
                                       int lane) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = frag_word(rows, stride, n, d, lane, kk, e);
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&f)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = a[kk][e];
  }
};

template <typename T> struct Reload {
  const T* rows;
  long long stride;
  int n, d, lane;
  __device__ __forceinline__ void load(const T* r, long long s, int n_, int d_, int l) {
    rows = r;
    stride = s;
    n = n_;
    d = d_;
    lane = l;
  }
};
template <int DP> struct Frag<bf16, DP, kReload> : Reload<bf16> {
  __device__ __forceinline__ void get(int kk, uint32_t (&f)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = frag_word(rows, stride, n, d, lane, kk, e);
  }
};

template <int DP> struct Frag<float, DP, kHeld> {  // whole values, split at each use
  float a[DP / 8][4];
  __device__ __forceinline__ void load(const float* rows, long long stride, int n, int d,
                                       int lane) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[kk][e] = __uint_as_float(frag_word(rows, stride, n, d, lane, kk, e));
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) leaf::split_tf32(a[kk][e], hi[e], lo[e]);
  }
};
template <int DP> struct Frag<float, DP, kHeldSplit> {
  uint32_t hi_[DP / 8][4], lo_[DP / 8][4];
  __device__ __forceinline__ void load(const float* rows, long long stride, int n, int d,
                                       int lane) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        leaf::split_tf32(__uint_as_float(frag_word(rows, stride, n, d, lane, kk, e)),
                         hi_[kk][e], lo_[kk][e]);
  }
  __device__ __forceinline__ void get(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = hi_[kk][e];
      lo[e] = lo_[kk][e];
    }
  }
};
template <int DP> struct Frag<float, DP, kReload> : Reload<float> {
  __device__ __forceinline__ void get(int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      leaf::split_tf32(__uint_as_float(frag_word(rows, stride, n, d, lane, kk, e)), hi[e],
                       lo[e]);
  }
};

// how each kernel holds its own rows (see the top): registers where they fit
template <typename T, int DP> constexpr int dq_mode() {
  return sizeof(T) == 2 ? kHeld : DP <= 64 ? kHeldSplit : DP <= 80 ? kHeld : kReload;
}
template <typename T, int DP> constexpr int dkv_mode() {
  return sizeof(T) == 2 ? (DP <= 96 ? kHeld : kReload)
                        : DP <= 32 ? kHeldSplit : DP <= 80 ? kHeld : kReload;
}

// delta (dO . O) of this lane's two rows, g and g + 8 of the n below rows
// (zero past n), summed over the quad: fp32 products of the dtype's values
template <typename T, int DP>
__device__ __forceinline__ void row_deltas(float (&delta)[2], const T* dO, const T* o,
                                           long long stride, int n, int d, int lane) {
  constexpr int kSteps = sizeof(T) == 2 ? DP / 16 : DP / 8;
  constexpr int kE = sizeof(T) == 2 ? 2 : 1;  // elements of a word
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a[kE], b[kE];
      leaf::Word<T>::unpack(frag_word(dO, stride, n, d, lane, kk, e), a);
      leaf::Word<T>::unpack(frag_word(o, stride, n, d, lane, kk, e), b);
#pragma unroll
      for (int i = 0; i < kE; ++i) s[e & 1] = fmaf(a[i], b[i], s[e & 1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) delta[r] = leaf::mma::quad_sum(s[r]);
}

// ---------------------------------------------------------------------------
// Products: bf16 as `mma.sync.m16n8k16`, fp32 as three TF32 `m16n8k8`
// products of operands split into hi + lo (3xTF32)
// ---------------------------------------------------------------------------

// c (16 rows x 16 columns as two m16n8 accumulators) = A . B[16][DP]^T, A the
// warp's own rows, B 16 staged rows
template <int DP, typename F>
__device__ __forceinline__ void scores(float (&c)[2][4], const F& A, const bf16* B,
                                       const Lanes& ln) {
  constexpr int kStride = DP + pad<bf16>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4], b[4];
    A.get(kk, a);
    leaf::ldmatrix_x4(b, B + ln.b_row * kStride + kk * 16 + ln.b_col);
    leaf::mma::mma_16816(c[0], a, b[0], b[1]);
    leaf::mma::mma_16816(c[1], a, b[2], b[3]);
  }
}
template <int DP, typename F>
__device__ __forceinline__ void scores(float (&c)[2][4], const F& A, const float* B,
                                       const Lanes& ln) {
  constexpr int kStride = DP + pad<float>();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[h][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ah[4], al[4], b[4], bh[4], bl[4];
    A.get(kk, ah, al);
    leaf::ldmatrix_x4(b, B + ln.b_row * kStride + kk * 8 + ln.b_col);
#pragma unroll
    for (int e = 0; e < 4; ++e) leaf::split_tf32(__uint_as_float(b[e]), bh[e], bl[e]);
    leaf::mma_3xtf32(c[0], ah, al, bh[0], bh[1], bl[0], bl[1]);
    leaf::mma_3xtf32(c[1], ah, al, bh[2], bh[3], bl[2], bl[3]);
  }
}

// dP as the reference rounds it: each of the tile's pairs (elements 0, 1 and
// 2, 3 of an accumulator) rounded to the dtype by one packed conversion
template <typename T>
__device__ __forceinline__ void round_pairs(float (&dp)[2][4]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const uint32_t w = leaf::mma::pack_bf16(dp[h][e], dp[h][e + 1]);
        dp[h][e] = __uint_as_float(w << 16);
        dp[h][e + 1] = __uint_as_float(w & 0xffff0000u);
      }
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
  if (kSplit) {  // lo = c - hi, hi read back from its packed words
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* cw = &c[w >> 1][2 * (w & 1)];
      lo[w] = leaf::mma::pack_bf16(cw[0] - __uint_as_float(hi[w] << 16),
                                   cw[1] - __uint_as_float(hi[w] & 0xffff0000u));
    }
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

// Where chunk c of a block's range [b0, b1) lies in the staging buffer, and how
// many rows it stages: whole, at row 64c of `whole` rows; the ring, in stage
// c % 2 of 64 rows.
__device__ __forceinline__ int chunk_row(int whole, int c) {
  return whole ? c * kChunk : (c & 1) * kChunk;
}
__device__ __forceinline__ int chunk_rows(int whole, int c) {
  return whole ? imin(kChunk, whole - c * kChunk) : kChunk;
}

// the staged chunk c ready in shared memory: whole, every chunk landed at
// the first (one wait and one barrier for the block; after it the warps run
// free of each other); the ring, chunk c + 1 staged first by `stage_next`
// (its copy overlaps chunk c's products)
template <typename F>
__device__ __forceinline__ void chunk_ready(int whole, int c, int n_chunks,
                                            const F& stage_next) {
  if (whole) {
    if (c > 0) return;
    leaf::cp_async_wait<0>();
  } else if (c + 1 < n_chunks) {
    stage_next(c + 1);
    leaf::cp_async_wait<1>();
  } else {
    leaf::cp_async_wait<0>();
  }
  __syncthreads();
}

// ===========================================================================
// dQ: a warp owns 16 queries
// ===========================================================================

template <typename T, int DP, int kMode>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
    attention_backward_dq_kernel(const BwdArgs p) {
  constexpr int kStride = DP + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf = p.whole ? p.whole : 2 * kChunk;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + buf * kStride;

  const Span sp = block_span<false>(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int gl = p.group_len;
  const long long D = (long long)p.H * p.d;
  const long long tok0 = (long long)sp.r * p.L;
  const T* q = static_cast<const T*>(p.qkv) + tok0 * 3 * D + (long long)sp.h * p.d;
  const T* k = q + D;
  const T* v = q + 2 * D;
  const T* o = static_cast<const T*>(p.out) + tok0 * D + (long long)sp.h * p.d;
  const T* dO = static_cast<const T*>(p.dout) + tok0 * D + (long long)sp.h * p.d;
  const long long stat0 = ((long long)sp.r * p.H + sp.h) * p.L;

  // the keys and values the block's queries see, in chunks
  const int n_chunks = (sp.b1 - sp.b0 + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int c) {
    const int at = chunk_row(p.whole, c), rows = chunk_rows(p.whole, c);
    const int j0 = sp.b0 + c * kChunk;
    stage<DP>(Ks + at * kStride, k, 3 * D, j0, rows, sp.b1, p.d);
    stage<DP>(Vs + at * kStride, v, 3 * D, j0, rows, sp.b1, p.d);
    leaf::cp_async_commit();
  };
  for (int c = 0; c < (p.whole ? n_chunks : 1); ++c) stage_chunk(c);

  // the warp's 16 queries, the keys they see, the keys all of them see, and
  // this lane's two rows
  const int w0 = sp.a0 + kRows * warp, w1 = imin(w0 + kRows, sp.a1);
  const bool active = w0 < sp.a1;
  const int n = active ? w1 - w0 : 0;
  int wk0 = 0, wk1 = 0;
  if (active) key_range(w0, w1, p.L, gl, p.causal, wk0, wk1);
  const int all0 = active ? (w1 - 1) / gl * gl : 0;
  const int all1 = p.causal ? w0 + 1 : imin((w0 / gl + 1) * gl, p.L);
  const int qi[2] = {w0 + g, w0 + g + 8};
  const bool own[2] = {qi[0] < w1, qi[1] < w1};

  Frag<T, DP, kMode> qf, dof;
  qf.load(q + (long long)w0 * 3 * D, 3 * D, n, p.d, lane);
  dof.load(dO + (long long)w0 * D, D, n, p.d, lane);
  float delta[2], delta_scaled[2], lse2[2];
  row_deltas<T, DP>(delta, dO + (long long)w0 * D, o + (long long)w0 * D, D, n, p.d, lane);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = own[r] ? p.lse[stat0 + qi[r]] * kLog2e : 0.f;
    delta_scaled[r] = delta[r] * p.scale;
    if (t == 0 && own[r]) p.delta[stat0 + qi[r]] = delta[r];
  }
  const float scale_log2e = p.scale * kLog2e;
  const Lanes ln = lanes<T>(lane);

  float dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    chunk_ready(p.whole, c, n_chunks, stage_chunk);
    const int cs = sp.b0 + c * kChunk, ce = imin(cs + kChunk, sp.b1);
    const int lo = imax(wk0, cs), hi = imin(wk1, ce);
    if (active && lo < hi) {
      const T* Kc = Ks + chunk_row(p.whole, c) * kStride;
      const T* Vc = Vs + chunk_row(p.whole, c) * kStride;
      for (int kr = (lo - cs) & ~15; kr < hi - cs; kr += kRows) {
        const int c0 = cs + kr;
        float s[2][4], dp[2][4];
        scores<DP>(s, qf, Kc + kr * kStride, ln);
        scores<DP>(dp, dof, Vc + kr * kStride, ln);
        round_pairs<T>(dp);
        const bool full = c0 >= all0 && c0 + kRows <= all1;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, kj = c0 + 8 * h + 2 * t + (e & 1);
            float ds = 0.f;
            if (full || (own[r] && kj < sp.b1 && visible(qi[r], kj, gl, p.causal))) {
              const float pr = leaf::mma::fast_exp2(fmaf(s[h][e], scale_log2e, -lse2[r]));
              ds = pr * fmaf(dp[h][e], p.scale, -delta_scaled[r]);
            }
            s[h][e] = ds;
          }
        product<DP, true>(dq, s, Kc + kr * kStride, ln, lane);
      }
    }
    if (!p.whole && c + 1 < n_chunks) __syncthreads();  // this stage is refilled next
  }
  if (active)
    store<T, DP>(static_cast<T*>(p.dqkv) + (tok0 + sp.a0) * 3 * D + (long long)sp.h * p.d, dq,
                 kRows * warp, sp.a1 - sp.a0, 3 * D, p.d, lane);
}

// ===========================================================================
// dK and dV: a warp owns 16 keys
// ===========================================================================

template <typename T, int DP, int kMode>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
    attention_backward_dkv_kernel(const BwdArgs p) {
  constexpr int kStride = DP + pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf = p.whole ? p.whole : 2 * kChunk;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + buf * kStride;
  float* lse_s = reinterpret_cast<float*>(dOs + buf * kStride);
  float* delta_s = lse_s + buf;

  const Span sp = block_span<true>(p);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int gl = p.group_len;
  const long long D = (long long)p.H * p.d;
  const long long tok0 = (long long)sp.r * p.L;
  const T* q = static_cast<const T*>(p.qkv) + tok0 * 3 * D + (long long)sp.h * p.d;
  const T* k = q + D;
  const T* v = q + 2 * D;
  const T* dO = static_cast<const T*>(p.dout) + tok0 * D + (long long)sp.h * p.d;
  const long long stat0 = ((long long)sp.r * p.H + sp.h) * p.L;

  // the queries that see the block's keys (q, dO, lse, delta), in chunks
  const int n_chunks = (sp.b1 - sp.b0 + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int c) {
    const int at = chunk_row(p.whole, c), rows = chunk_rows(p.whole, c);
    const int i0 = sp.b0 + c * kChunk;
    stage<DP>(Qs + at * kStride, q, 3 * D, i0, rows, sp.b1, p.d);
    stage<DP>(dOs + at * kStride, dO, D, i0, rows, sp.b1, p.d);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      const bool valid = i0 + i < sp.b1;
      const long long at_stat = stat0 + (valid ? i0 + i : 0);
      leaf::cp_async4(lse_s + at + i, p.lse + at_stat, valid);
      leaf::cp_async4(delta_s + at + i, p.delta + at_stat, valid);
    }
    leaf::cp_async_commit();
  };
  for (int c = 0; c < (p.whole ? n_chunks : 1); ++c) stage_chunk(c);

  // the warp's 16 keys, the queries that see them, the queries that see all
  // of them, and this lane's two rows
  const int w0 = sp.a0 + kRows * warp, w1 = imin(w0 + kRows, sp.a1);
  const bool active = w0 < sp.a1;
  const int n = active ? w1 - w0 : 0;
  int wi0 = 0, wi1 = 0;
  if (active) query_range(w0, w1, p.L, gl, p.causal, wi0, wi1);
  const int all0 = active ? imax((w1 - 1) / gl * gl, p.causal ? w1 - 1 : 0) : 0;
  const int all1 = imin((w0 / gl + 1) * gl, p.L);
  const int kj[2] = {w0 + g, w0 + g + 8};
  const bool own[2] = {kj[0] < w1, kj[1] < w1};

  Frag<T, DP, kMode> kf, vf;
  kf.load(k + (long long)w0 * 3 * D, 3 * D, n, p.d, lane);
  vf.load(v + (long long)w0 * 3 * D, 3 * D, n, p.d, lane);
  const float scale_log2e = p.scale * kLog2e;
  const Lanes ln = lanes<T>(lane);

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    chunk_ready(p.whole, c, n_chunks, stage_chunk);
    const int cs = sp.b0 + c * kChunk, ce = imin(cs + kChunk, sp.b1);
    const int lo = imax(wi0, cs), hi = imin(wi1, ce);
    if (active && lo < hi) {
      const int at = chunk_row(p.whole, c);
      const T* Qc = Qs + at * kStride;
      const T* dOc = dOs + at * kStride;
      for (int qr = (lo - cs) & ~15; qr < hi - cs; qr += kRows) {
        const int c0 = cs + qr;
        float s[2][4], dp[2][4];  // [key g (+8)][query]
        scores<DP>(s, kf, Qc + qr * kStride, ln);
        scores<DP>(dp, vf, dOc + qr * kStride, ln);
        round_pairs<T>(dp);
        const bool full = c0 >= all0 && c0 + kRows <= all1;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * h + 2 * t + (e & 1), qi = c0 + col, r = e >> 1;
            float pr = 0.f, ds = 0.f;
            if (full || (own[r] && qi < sp.b1 && visible(qi, kj[r], gl, p.causal))) {
              const int st = at + qr + col;
              pr = leaf::mma::fast_exp2(fmaf(s[h][e], scale_log2e, -lse_s[st] * kLog2e));
              ds = pr * fmaf(dp[h][e], p.scale, -delta_s[st] * p.scale);
            }
            s[h][e] = pr;
            dp[h][e] = ds;
          }
        product<DP, false>(dv, s, dOc + qr * kStride, ln, lane);
        product<DP, true>(dk, dp, Qc + qr * kStride, ln, lane);
      }
    }
    if (!p.whole && c + 1 < n_chunks) __syncthreads();  // this stage is refilled next
  }
  if (active) {
    T* base = static_cast<T*>(p.dqkv) + (tok0 + sp.a0) * 3 * D + (long long)sp.h * p.d;
    store<T, DP>(base + D, dk, kRows * warp, sp.a1 - sp.a0, 3 * D, p.d, lane);
    store<T, DP>(base + 2 * D, dv, kRows * warp, sp.a1 - sp.a0, 3 * D, p.d, lane);
  }
}

// the most rows a block stages whole in `dtype`, lowered to `max_whole` where
// that is positive; -1 for a dtype the kernels do not take
inline int whole_limit(int dtype, int max_whole) {
  const int limit = dtype == leaf::kFloat32 ? kMaxWholeF32
                    : dtype == leaf::kBFloat16 ? kMaxWhole : -1;
  return limit > 0 && max_whole > 0 && max_whole < limit ? max_whole : limit;
}

// shared memory of a kernel that stages `whole` rows (0: the ring's two
// chunks): two operands' padded rows, and (dK/dV) the lse and delta
template <typename T, int DP>
constexpr int smem_bytes(int whole, bool stats) {
  const int rows = whole ? whole : 2 * kChunk;
  return rows * (2 * (DP + pad<T>()) * (int)sizeof(T) + (stats ? 2 * (int)sizeof(float) : 0));
}

template <typename T, int DP>
cudaError_t launch_width(BwdArgs p, const Plan& pl, cudaStream_t stream) {
  auto dq = attention_backward_dq_kernel<T, DP, dq_mode<T, DP>()>;
  auto dkv = attention_backward_dkv_kernel<T, DP, dkv_mode<T, DP>()>;
  const unsigned grid = (unsigned)((long long)pl.blocks * p.H * p.R);
  const int threads = pl.warps * 32;
  p.warps = pl.warps;
  p.blocks = pl.blocks;
  p.whole = pl.dq_whole;
  int bytes = smem_bytes<T, DP>(p.whole, false);
  cudaError_t err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dq<<<grid, threads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.whole = pl.dkv_whole;
  bytes = smem_bytes<T, DP>(p.whole, true);
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dkv<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// DP: the head width rounded up to 32, 64, 80, 96 or 128 (ViT-H's heads of 80
// at their width)
template <typename T>
cudaError_t launch(const BwdArgs& p, const Plan& pl, cudaStream_t stream) {
  if (sizeof(T) == 2 && p.d % 8) return cudaErrorInvalidValue;  // 16-byte pieces
  if (p.d <= 32) return launch_width<T, 32>(p, pl, stream);
  if (p.d <= 64) return launch_width<T, 64>(p, pl, stream);
  if (p.d <= 80) return launch_width<T, 80>(p, pl, stream);
  if (p.d <= 96) return launch_width<T, 96>(p, pl, stream);
  return launch_width<T, 128>(p, pl, stream);
}

}  // namespace


// dqkv [R, L, 3D] from qkv [R, L, 3D], the forward's out, its lse [R, H, L]
// (fp32, natural log) and the gradient dout [R, L, D] (qkv, out, dout and dqkv
// of `dtype`; all contiguous, 16-byte aligned; bf16 heads a multiple of 8
// wide); `delta` is fp32 scratch [R, H, L], written by the first kernel and
// read by the second.  `max_whole`: 0, or fewer rows than the dtype's limit
// to stage whole (the ring takes longer ranges).
extern "C" int leaf_packed_attention_backward(const void* qkv, const void* out,
                                              const void* lse, const void* dout, void* dqkv,
                                              void* delta, int dtype, int R, int L,
                                              int n_heads, int head_dim, int group_len,
                                              int causal, float scale, int max_whole,
                                              int device, void* stream) {
  if (R <= 0 || L <= 0 || n_heads <= 0 || head_dim <= 0 || head_dim > kMaxHeadDim ||
      group_len <= 0)
    return cudaErrorInvalidValue;
  const int limit = whole_limit(dtype, max_whole);
  if (limit < 0) return cudaErrorInvalidValue;
  const Plan pl = make_plan(L, group_len, causal, limit);
  if ((long long)pl.blocks * n_heads * R > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const BwdArgs p = {qkv,       out,   dout,    dqkv,     static_cast<const float*>(lse),
                     static_cast<float*>(delta), R, L, n_heads, head_dim, group_len, causal,
                     0,         0,     0,       scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == leaf::kFloat32) return launch<float>(p, pl, s);
  return launch<bf16>(p, pl, s);
}

// The backward's plan for one row of L tokens in `dtype` (max_whole as the
// launch takes it), computed on the host and launching nothing: plan = {warps,
// blocks, rows the dQ kernel stages whole (0: the ring), the same of dK/dV};
// `ranges` receives, for each dQ block, {q0, q1, k0, k1} (its queries and the
// keys it stages), then for each dK/dV block {k0, k1, i0, i1}; returns the
// number of blocks of one kernel, or -1 if 8 x that is more than `cap`.
extern "C" int leaf_attention_backward_schedule(int L, int group_len, int causal, int dtype,
                                                int max_whole, int* plan, int* ranges,
                                                int cap) {
  const int limit = whole_limit(dtype, max_whole);
  if (L <= 0 || group_len <= 0 || limit < 0) return -1;
  const Plan pl = make_plan(L, group_len, causal, limit);
  if (8 * pl.blocks > cap) return -1;
  const int fields[4] = {pl.warps, pl.blocks, pl.dq_whole, pl.dkv_whole};
  for (int i = 0; i < 4; ++i) plan[i] = fields[i];
  for (int b = 0; b < pl.blocks; ++b) {
    const int a0 = b * pl.warps * kRows, a1 = imin(a0 + pl.warps * kRows, L);
    int* dq = ranges + 4 * b;
    int* dkv = ranges + 4 * (pl.blocks + b);
    dq[0] = dkv[0] = a0;
    dq[1] = dkv[1] = a1;
    key_range(a0, a1, L, group_len, causal, dq[2], dq[3]);
    query_range(a0, a1, L, group_len, causal, dkv[2], dkv[3]);
  }
  return pl.blocks;
}
