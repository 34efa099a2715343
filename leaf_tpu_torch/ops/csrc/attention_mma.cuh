// Tensor-core attention core shared by the packed and the flash attention
// kernels (sm_90a): QK^T and PV as warp-level `mma.sync` products, bf16 and
// fp32, for both kernels in both dtypes.
//
// Replaces the inner loops of two Pallas kernels: `_kernel` of
// leaf_tpu/ops/packed_attention.py (and through it the attention stage of
// `_block_kernel`) and `_attn_kernel` of leaf_tpu/ops/flash_attention.py.  Both
// compute, for one (batch row, head), out_i = sum_j p_ij v_j with p = softmax
// of the scaled logits q_i . k_j over the keys j of query i's `group_len`
// block (j <= i when causal); flash attention is the case of one group.
//
// What bounds it on the H100: at the shapes the towers run (at most 257
// tokens, heads of 64) a (row, head) pair does at most 17 MFLOP on 130 KB of
// q, k, v and out, ~130 operations per byte, below the tensor cores' ratio
// (~295): the card's bound is the bytes.  A kernel gets near it only if the
// products run on the tensor cores and the softmax stays in registers, so
// that what is left is the copy of K and V into shared memory.  In fp32 each
// product is three TF32 products (3xTF32, `common.cuh`), at a third of the
// TF32 rate: ~165 TFLOP/s against 67 for fp32 FMAs; there the operations
// bound the vision rows.
//
// Design.  A warp owns a tile of 16 queries; a block is up to 8 such warps on
// consecutive tiles of one (row, head) and stages, by 16-byte `cp.async`, the
// keys and values its queries can see, in rows padded by 16 bytes so that the
// 8 rows of an `ldmatrix` fall in 8 different bank groups.  Masks are index
// arithmetic on (group_len, causal, L): a 16-key step that no query of the
// warp's tile can see is skipped, ragged edges are zero-filled in shared
// memory and masked in registers, nothing is padded in device memory.  Row
// maxima and sums cross the 4 lanes of a quad by shuffle.
//   * bf16: products are `mma.sync.m16n8k16` (bf16 in, fp32 out), fragments
//     loaded by `ldmatrix` (`.trans` for V).  The logit accumulators of two
//     m16n8 tiles have the register layout of the A operand of the next m16k16
//     product, so the probabilities are rounded to bf16 in registers and go
//     into PV without touching shared memory.
//   * fp32: products are `mma.sync.m16n8k8` TF32, each operand split in
//     registers into hi + lo as it is loaded (3xTF32: fp32 accuracy, held to
//     1e-4 where one TF32 pass is off by ~1e-3).  Q and K fragments come by
//     `ldmatrix`, which moves 32-bit words as pairs of halves: an 8 x 4 fp32
//     block is an 8 x 8 b16 one.  V cannot be transposed so (32-bit
//     elements): its B fragments are scalar shared loads.  The logit
//     accumulators (columns 2t and 2t + 1 in lane t of a quad) are not the
//     m16n8k8 A layout (columns t and t + 4), so PV takes the 8 keys of a step
//     in another order, A's column t being key 2t and t + 4 key 2t + 1: the
//     probabilities feed PV from the accumulators as they are, and V's loads
//     read rows 2t and 2t + 1.  Rows of DP + 4 floats (DP + 4 = 4 mod 8 words)
//     keep both `ldmatrix` and those loads free of bank conflicts.  Q stays in
//     shared memory and is reloaded and split each pass (its hi and lo for a
//     head of 128 would take 128 registers a thread); the probabilities stay
//     fp32 into PV, as in the JAX kernel's fp32 path.  Heads narrower than the
//     compiled width skip the k-steps and output columns past them.
//
// `make_plan` picks, on the host and from the shape alone, how keys are staged
// and how the softmax runs:
//   * staging: a block whose key range is at most 352 rows in bf16 or 144 in
//     fp32 (what fits 227 KB beside the query tile at d = 128: every text
//     shape in both, the vision tower's 272 in bf16) copies it whole, waits
//     once, and its warps then run free of each other; a longer range goes
//     through a ring of two 64-key stages (the copy of stage c + 1 overlaps
//     the products of stage c, two block barriers a stage), which was slower
//     at the vision shape in bf16, where warps freed of the barriers drift
//     apart and overlap products with softmax.
//   * exact softmax (kExact): every tile's visible keys fit in 16 (NT = 2) or
//     80 (NT = 10) logit columns.  Each warp holds its full logit rows in
//     registers and does the two-pass softmax of the JAX packed kernel:
//     probabilities normalised, then (bf16) rounded.  All text shapes
//     (buckets 16 to 77) take it.
//   * online softmax: passes of 64 keys with running maximum and sum as in
//     the JAX flash kernel; in bf16 the probabilities are rounded before the
//     final division by the sum.  Longer rows (the vision tower's, whose 272
//     logit columns would need ~135 registers a thread) and every
//     flash-attention call take it.
// Where the caller sets `lse` (the packed kernel's training forward), each
// query's log-sum-exp, m + log2(l) in natural units, is written beside the
// output for the backward kernels (attention_backward.cu); serving and flash
// attention leave it null.
// A warp with two m16 tiles (32 queries, every K and V fragment feeding two
// products) was tried for the bf16 online softmax: 214 registers, one block
// per SM, and more than twice the time at the vision shape; not kept.
// `leaf_tpu_torch/ops/packed_attention.py::tile_schedule` mirrors `make_plan`
// and the per-warp key steps in Python, for the CPU tests; `list_passes` below
// gives this file's own answer, and `chip_smoke.py` holds the mirror to it.
#pragma once

#include <math.h>

#include "common.cuh"

namespace leaf {
namespace mma {

constexpr int kTile = 16;            // rows of an mma tile
constexpr int kMaxWarps = 8;         // warps (query tiles) per block
constexpr int kPad = 8;              // bf16 elements of padding per staged row
constexpr int kPadF32 = 4;           // fp32 elements of padding per staged row
constexpr int kOnlineChunk = 64;     // keys per pass of the online softmax, and per ring stage
constexpr int kMaxWholeChunk = 352;  // bf16 rows staged at once that fit 227 KB at d = 128
constexpr int kMaxWholeChunkF32 = 144;  // the same in fp32
constexpr int kMaxHeadDim = 128;

using bf16 = __nv_bfloat16;

// keys [k0, k1) that queries [q0, q1) of one row may attend to
__host__ __device__ inline void key_range(int q0, int q1, int L, int group_len,
                                          int causal, int* k0, int* k1) {
  *k0 = (q0 / group_len) * group_len;
  int end = ((q1 - 1) / group_len + 1) * group_len;
  end = end < L ? end : L;
  if (causal && q1 < end) end = q1;
  *k1 = end;
}

// Strides are in elements, for (batch, head, token); the head width is dense.
template <typename T> struct ParamsT {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  long long qs[3], ks[3], vs[3], os[3];
  int B, H, L, d, group_len, causal;
  int chunk;          // keys per stage, a multiple of 16
  int stages;         // 1: the block's whole key range is staged; 2: a ring
  int blocks;         // blocks per (row, head)
  int vec;            // fp32: rows move in 16-byte pieces (else word by word)
  float scale_log2e;  // softmax scale times log2(e): the exponentials are exp2
  float* lse;         // [B, H, L]: each query's log-sum-exp (natural log), or null
};
using Params = ParamsT<bf16>;

struct Plan {
  int warps, blocks;  // warps (16-query tiles) per block, blocks per (row, head)
  int chunk, stages;  // as in Params
  int nt;             // logit columns / 8 a warp holds per pass
  bool exact;
};

// max_whole: the most key rows a block stages at once (kMaxWholeChunk in
// bf16, kMaxWholeChunkF32 in fp32)
inline Plan make_plan(int L, int group_len, int causal, bool allow_exact,
                      int max_whole = kMaxWholeChunk) {
  Plan pl;
  const int tiles = (L + kTile - 1) / kTile;
  pl.blocks = (tiles + kMaxWarps - 1) / kMaxWarps;
  pl.warps = (tiles + pl.blocks - 1) / pl.blocks;
  const int block_q = pl.warps * kTile;
  int span = 0, steps = 0;  // widest block key range; most 16-key steps of a tile
  for (int q0 = 0; q0 < L; q0 += block_q) {
    const int q1 = q0 + block_q < L ? q0 + block_q : L;
    int k0, k1;
    key_range(q0, q1, L, group_len, causal, &k0, &k1);
    span = k1 - k0 > span ? k1 - k0 : span;
    for (int w0 = q0; w0 < q1; w0 += kTile) {
      const int w1 = w0 + kTile < q1 ? w0 + kTile : q1;
      int a, b;
      key_range(w0, w1, L, group_len, causal, &a, &b);
      const int lo = (a - k0) & ~15;
      const int n = (b - k0 - lo + 15) / 16;
      steps = n > steps ? n : steps;
    }
  }
  const int whole = (span + 15) & ~15;
  pl.stages = whole <= max_whole ? 1 : 2;
  pl.chunk = pl.stages == 1 ? whole : kOnlineChunk;
  pl.exact = allow_exact && steps <= 5 && pl.stages == 1;
  pl.nt = pl.exact ? (steps <= 1 ? 2 : 10) : kOnlineChunk / 8;
  return pl;
}

// A tile that sees keys [wk0, wk1) works on rows [lo, hi) of the chunk staged
// from key cs on (none if lo >= hi), in passes of nt * 8 logit columns from
// the 16-key step that holds lo: `pass_steps` gives the 16-key steps of the
// pass that starts at row k, and its end.  The kernel and `list_passes` both
// walk a tile's keys through these.
__host__ __device__ inline void chunk_window(int wk0, int wk1, int cs, int chunk,
                                             int* lo, int* hi) {
  *lo = (wk0 > cs ? wk0 : cs) - cs;
  *hi = (wk1 < cs + chunk ? wk1 : cs + chunk) - cs;
}
__host__ __device__ inline int first_pass(int lo) { return lo & ~15; }
__host__ __device__ inline int pass_steps(int k, int hi, int nt, int* k_end) {
  *k_end = hi < k + 8 * nt ? hi : k + 8 * nt;
  return (*k_end - k + 15) / 16;
}

// Every pass the kernel makes for one row under plan `pl`, tile by tile, as
// (tile, first key, one past the last key of its 16-key steps) triples in
// `out`; returns their number, or -1 if it is more than `cap`.  It is how the
// Python mirror of the schedule is held to this file on the card.
inline int list_passes(int L, int group_len, int causal, const Plan& pl, int* out,
                       int cap) {
  const int block_q = pl.warps * kTile;
  int n = 0;
  for (int bq0 = 0; bq0 < L; bq0 += block_q) {
    const int bq1 = bq0 + block_q < L ? bq0 + block_q : L;
    int bk0, bk1;
    key_range(bq0, bq1, L, group_len, causal, &bk0, &bk1);
    for (int wq0 = bq0; wq0 < bq1; wq0 += kTile) {
      const int wq1 = wq0 + kTile < bq1 ? wq0 + kTile : bq1;
      int wk0, wk1;
      key_range(wq0, wq1, L, group_len, causal, &wk0, &wk1);
      for (int cs = bk0; cs < bk1; cs += pl.chunk) {
        int lo, hi;
        chunk_window(wk0, wk1, cs, pl.chunk, &lo, &hi);
        for (int k = first_pass(lo); k < hi; k += 8 * pl.nt) {
          int k_end;
          const int steps = pass_steps(k, hi, pl.nt, &k_end);
          if (n == cap) return -1;
          out[3 * n] = wq0 / kTile;
          out[3 * n + 1] = cs + k;
          out[3 * n + 2] = cs + k + 16 * steps;
          ++n;
        }
      }
    }
  }
  return n;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x by the special-function unit (exp2f wraps it in range handling that the
// softmax does not need: its arguments are <= 0, and 2^-inf is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [row0, row0 + rows) of a matrix with `stride` elements between rows ->
// shared memory rows of DP + kPad elements; rows at or past row_end and
// columns at or past d are zero.  Every thread of the block takes part.
template <int DP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride,
                                           int row0, int rows, int row_end, int d) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool valid = row0 + r < row_end && c * 8 < d;
    const bf16* s = valid ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async16(dst + r * (DP + kPad) + c * 8, s, valid);
  }
}

// The same for fp32 rows of DP + kPadF32 floats: in 16-byte pieces where
// `vec` (d and the strides multiples of 4 floats), else word by word.
template <int DP>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, long long stride,
                                               int row0, int rows, int row_end, int d,
                                               bool vec) {
  constexpr int kStride = DP + kPadF32;
  if (vec) {
    constexpr int kChunks = DP / 4;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
      const int r = idx / kChunks, c = idx - r * kChunks;
      const bool valid = row0 + r < row_end && c * 4 < d;
      const float* s = valid ? src + (long long)(row0 + r) * stride + c * 4 : src;
      cp_async16(dst + r * kStride + c * 4, s, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += blockDim.x) {
      const int r = idx / DP, c = idx - r * DP;
      const bool valid = row0 + r < row_end && c < d;
      const float* s = valid ? src + (long long)(row0 + r) * stride + c : src;
      cp_async4(dst + r * kStride + c, s, valid);
    }
  }
}

// A block's queries and keys, and what its warp's tile and this lane's two
// query rows (accumulator rows lane / 4 and + 8) can see.
struct Geometry {
  int row, head;
  int bq0, bq1, bk0, bk1;  // the block's queries and the keys they may see
  int wq0, wq1, wk0, wk1;  // the warp's tile and its keys
  bool active;             // a warp past the row's end only helps staging
  int vis0[2], vis1[2];    // keys each of the lane's rows sees; none past the end
  // keys seen by every query of the tile (rows past the end, which are not
  // stored, aside)
  int tile_vis0, tile_vis1;
};

// blockIdx.x counts blocks of a (row, head) fastest, then heads
template <typename P>
__device__ __forceinline__ Geometry geometry(const P& p, int warps, int warp, int lane) {
  Geometry gm;
  gm.row = blockIdx.x / (p.blocks * p.H);
  gm.head = blockIdx.x / p.blocks % p.H;
  gm.bq0 = blockIdx.x % p.blocks * warps * kTile;
  gm.bq1 = min(gm.bq0 + warps * kTile, p.L);
  key_range(gm.bq0, gm.bq1, p.L, p.group_len, p.causal, &gm.bk0, &gm.bk1);
  gm.wq0 = gm.bq0 + warp * kTile;
  gm.wq1 = min(gm.wq0 + kTile, gm.bq1);
  gm.active = gm.wq0 < gm.bq1;
  gm.wk0 = gm.wk1 = 0;
  if (gm.active) key_range(gm.wq0, gm.wq1, p.L, p.group_len, p.causal, &gm.wk0, &gm.wk1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = gm.wq0 + lane / 4 + 8 * r;
    gm.vis0[r] = (qi / p.group_len) * p.group_len;
    gm.vis1[r] = p.causal ? qi + 1 : min(gm.vis0[r] + p.group_len, p.L);
    if (qi >= p.L) gm.vis1[r] = gm.vis0[r];
  }
  gm.tile_vis0 = ((gm.wq1 - 1) / p.group_len) * p.group_len;
  gm.tile_vis1 =
      p.causal ? gm.wq0 + 1 : min((gm.wq0 / p.group_len + 1) * p.group_len, p.L);
  return gm;
}

// What a warp knows of its tile: per-thread and per-tile visible key ranges and
// this lane's place in the fragments.
struct Tile {
  const int (&vis0)[2];
  const int (&vis1)[2];
  int tile_vis0, tile_vis1, lane, a_row, a_col, b_row, b_col;
};

// The row sum of this lane's row r (the quad's whole in the exact softmax,
// which kept it in `l`; this lane's share in the online one) and, where the
// caller asked for it (p.lse), the row's log-sum-exp, natural log, written by
// the quad's first lane: the backward kernels' softmax statistic.  m is the
// running maximum of the logits times scale log2(e); every query sees itself,
// so it is finite on every row the tile stores.
template <bool kExact, typename P>
__device__ __forceinline__ float row_sum_lse(const P& p, const Geometry& gm, float m,
                                             float l, int r, int lane) {
  const float sum = kExact ? l : quad_sum(l);
  const int qi = gm.wq0 + lane / 4 + 8 * r;
  if (p.lse != nullptr && lane % 4 == 0 && qi < gm.wq1)
    p.lse[((long long)gm.row * p.H + gm.head) * p.L + qi] =
        (m + log2f(sum)) * 0.6931471805599453f;
  return sum;
}

// One pass's softmax on the logits `s` of the tile against the `steps`
// 16-key steps from `key0` (keys at or past `key_end` are not this pass's):
// scale, mask, row maxima, exponentials; in place, `s` becomes the
// probabilities (normalised in the exact schedule), `m` the running maxima,
// `l` this thread's share of the running sums, and `o` is rescaled (online).
// kAll: steps == NT / 2, known at compile time.
template <int DP, int NT, bool kExact, bool kAll>
__device__ __forceinline__ void softmax_pass(float scale_log2e, const Tile& tile, int key0,
                                             int key_end, int steps, float (&s)[NT][4],
                                             float (&o)[DP / 8][4], float (&m)[2],
                                             float (&l)[2]) {
  const int lane = tile.lane;
  auto on = [&](int j2) { return kAll || j2 < steps; };
  // where every query of the tile sees every key of these steps
  // (warp-uniform), there is nothing to mask
  float mx[2] = {-INFINITY, -INFINITY};
  if (key0 >= tile.tile_vis0 && key0 + 16 * steps <= min(tile.tile_vis1, key_end)) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (on(j / 2)) {  // else left at 0, and out of PV
          s[j][e] *= scale_log2e;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (on(j / 2)) {
          const int r = e / 2;
          const int key = key0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const bool visible = key >= tile.vis0[r] && key < min(tile.vis1[r], key_end);
          s[j][e] = visible ? s[j][e] * scale_log2e : -INFINITY;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
  }
  float m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    // a row with no visible key so far keeps m = -inf: subtract 0, so
    // that its exponentials are 2^-inf = 0 and not 2^nan
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    if (!kExact) {
      const float alpha = fast_exp2(m[r] - m_use[r]);
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (on(j / 2)) {
        s[j][e] = fast_exp2(s[j][e] - m_use[e / 2]);
        sum[e / 2] += s[j][e];
      }
  if (kExact) {
    // the whole row is here: normalise (then, in bf16, round: the JAX
    // packed kernel); `l` keeps the row's sum for its log-sum-exp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(sum[r]);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] *= inv;
        s[j][2 * r + 1] *= inv;
      }
    }
  } else {
    l[0] += sum[0];  // this thread's share; the quad's sum is taken at the end
    l[1] += sum[1];
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// One warp, one pass: logits of its tile against the `steps` 16-key steps
// that start at key `key0` (staged at rows Kc and Vc), softmax update, PV.
// Keys at or past `key_end` are not this pass's.  kAll: steps == NT / 2, known
// at compile time.
template <int DP, int NT, bool kExact, bool kAll>
__device__ __forceinline__ void tile_pass(const Params& p, const Tile& tile,
                                           const bf16* Kc, const bf16* Vc, int key0,
                                           int key_end, int steps,
                                           const uint32_t (&qf)[DP / 16][4],
                                           float (&o)[DP / 8][4], float (&m)[2],
                                           float (&l)[2]) {
  constexpr int KD = DP / 16;
  constexpr int kStride = DP + kPad;
  auto on = [&](int j2) { return kAll || j2 < steps; };

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2)
      if (on(j2)) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kc + (16 * j2 + tile.b_row) * kStride + kk * 16 + tile.b_col);
        mma_16816(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_16816(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }

  softmax_pass<DP, NT, kExact, kAll>(p.scale_log2e, tile, key0, key_end, steps, s, o, m, l);

#pragma unroll
  for (int j2 = 0; j2 < NT / 2; ++j2)
    if (on(j2)) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * j2][0], s[2 * j2][1]);
      pf[1] = pack_bf16(s[2 * j2][2], s[2 * j2][3]);
      pf[2] = pack_bf16(s[2 * j2 + 1][0], s[2 * j2 + 1][1]);
      pf[3] = pack_bf16(s[2 * j2 + 1][2], s[2 * j2 + 1][3]);
#pragma unroll
      for (int nn = 0; nn < KD; ++nn) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vc + (16 * j2 + tile.a_row) * kStride + nn * 16 + tile.a_col);
        mma_16816(o[2 * nn], pf, vf[0], vf[1]);
        mma_16816(o[2 * nn + 1], pf, vf[2], vf[3]);
      }
    }
}

// One block: up to kMaxWarps consecutive 16-query tiles of one (row, head), a
// warp each.  DP: head width rounded up to a multiple of 32; NT: logit
// columns / 8 a warp holds per pass; kExact: the softmax (see the top).  Tag
// is a type of the including source file: each file's kernels are its own.
template <typename Tag, int DP, int NT, bool kExact>
__global__ void __launch_bounds__(kMaxWarps * 32) attention_kernel(const Params p) {
  constexpr int KD = DP / 16;  // k16 steps along the head width
  constexpr int kStride = DP + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [warps * kTile][kStride]
  bf16* Ks = Qs + warps * kTile * kStride;       // [stages][chunk][kStride]
  bf16* Vs = Ks + p.stages * p.chunk * kStride;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Geometry gm = geometry(p, warps, warp, lane);
  const int n_chunks = (gm.bk1 - gm.bk0 + p.chunk - 1) / p.chunk;

  const bf16* qb = p.q + gm.row * p.qs[0] + gm.head * p.qs[1];
  const bf16* kb = p.k + gm.row * p.ks[0] + gm.head * p.ks[1];
  const bf16* vb = p.v + gm.row * p.vs[0] + gm.head * p.vs[1];

  stage_rows<DP>(Qs, qb, p.qs[2], gm.bq0, warps * kTile, gm.bq1, p.d);
  stage_rows<DP>(Ks, kb, p.ks[2], gm.bk0, p.chunk, gm.bk1, p.d);
  stage_rows<DP>(Vs, vb, p.vs[2], gm.bk0, p.chunk, gm.bk1, p.d);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[DP / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // ldmatrix row and column of this lane inside a 16 x 16 block: A operand
  // and transposed B (V) take rows by lane % 16, B (K) by 8 * (lane / 16)
  const int a_row = lane % 8 + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);

  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) {
      const int nxt = (c + 1) & 1, k_next = gm.bk0 + (c + 1) * p.chunk;
      stage_rows<DP>(Ks + nxt * p.chunk * kStride, kb, p.ks[2], k_next, p.chunk, gm.bk1,
                     p.d);
      stage_rows<DP>(Vs + nxt * p.chunk * kStride, vb, p.vs[2], k_next, p.chunk, gm.bk1,
                     p.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c == 0 && gm.active) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * kTile + a_row) * kStride + kk * 16 + a_col);
    }

    const int cs = gm.bk0 + c * p.chunk;
    const bf16* Kc = Ks + (c & 1) * p.chunk * kStride;
    const bf16* Vc = Vs + (c & 1) * p.chunk * kStride;
    int lo, hi;
    chunk_window(gm.wk0, gm.wk1, cs, p.chunk, &lo, &hi);
    if (gm.active && lo < hi) {
      const Tile tile = {gm.vis0, gm.vis1, gm.tile_vis0, gm.tile_vis1,
                         lane, a_row, a_col, b_row, b_col};
      // the staged keys this tile can see, NT * 8 at a time (once, in the
      // exact schedule, by make_plan)
      for (int k = first_pass(lo); k < hi; k += 8 * NT) {
        int k_end;
        const int steps = pass_steps(k, hi, NT, &k_end);
        // a full pass, the common case of the online schedule, runs without
        // the per-step predicates, so that its products can be interleaved
        if (steps == NT / 2)
          tile_pass<DP, NT, kExact, true>(p, tile, Kc + k * kStride, Vc + k * kStride,
                                          cs + k, cs + k_end, steps, qf, o, m, l);
        else
          tile_pass<DP, NT, kExact, false>(p, tile, Kc + k * kStride, Vc + k * kStride,
                                           cs + k, cs + k_end, steps, qf, o, m, l);
      }
    }
    if (more) __syncthreads();  // this stage is refilled at the next turn
  }

  if (!gm.active) return;
  // round once, through this warp's own (now free) Q tile, then 16-byte stores
  bf16* tile = Qs + warp * kTile * kStride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = row_sum_lse<kExact>(p, gm, m[r], l[r], r, lane);
    const float inv = kExact ? 1.f : 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<uint32_t*>(tile + (lane / 4 + 8 * r) * kStride + 8 * j +
                                   2 * (lane % 4)) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncwarp();
  bf16* ob = p.out + gm.row * p.os[0] + gm.head * p.os[1];
  const int chunks = p.d / 8;
  for (int idx = lane; idx < (gm.wq1 - gm.wq0) * chunks; idx += 32) {
    const int r = idx / chunks, c = idx - r * chunks;
    *reinterpret_cast<uint4*>(ob + (long long)(gm.wq0 + r) * p.os[2] + c * 8) =
        *reinterpret_cast<const uint4*>(tile + r * kStride + c * 8);
  }
}

template <typename Tag, int DP, int NT, bool kExact>
cudaError_t launch_variant(const Params& p, const Plan& pl, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (DP + kPad) *
                      ((size_t)pl.warps * kTile + 2 * (size_t)pl.stages * pl.chunk);
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel<Tag, DP, NT, kExact>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)pl.blocks * p.H * p.B;
  attention_kernel<Tag, DP, NT, kExact><<<grid, pl.warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tag, bool kAllowExact, int DP>
cudaError_t launch_width(const Params& p, const Plan& pl, cudaStream_t stream) {
  if constexpr (kAllowExact) {
    if (pl.exact && pl.nt == 2) return launch_variant<Tag, DP, 2, true>(p, pl, stream);
    if (pl.exact) return launch_variant<Tag, DP, 10, true>(p, pl, stream);
  }
  return launch_variant<Tag, DP, kOnlineChunk / 8, false>(p, pl, stream);
}

// Fills p.chunk, p.stages, p.blocks and p.scale_log2e and launches the schedule `make_plan`
// picks.  The caller has set the pointers, strides and sizes.  kAllowExact:
// whether the exact softmax may run (and is compiled) for this caller.
template <typename Tag, bool kAllowExact>
cudaError_t launch(Params p, float scale, cudaStream_t stream) {
  if (p.B <= 0 || p.H <= 0 || p.L <= 0 || p.d <= 0 || p.d > kMaxHeadDim ||
      p.d % 8 != 0 || p.group_len <= 0)
    return cudaErrorInvalidValue;
  const Plan pl = make_plan(p.L, p.group_len, p.causal, kAllowExact);
  if ((long long)pl.blocks * p.H * p.B > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.chunk = pl.chunk;
  p.stages = pl.stages;
  p.blocks = pl.blocks;
  p.scale_log2e = scale * 1.4426950408889634f;
  if (p.d <= 32) return launch_width<Tag, kAllowExact, 32>(p, pl, stream);
  if (p.d <= 64) return launch_width<Tag, kAllowExact, 64>(p, pl, stream);
  if (p.d <= 96) return launch_width<Tag, kAllowExact, 96>(p, pl, stream);
  return launch_width<Tag, kAllowExact, 128>(p, pl, stream);
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 (see the top)
// ---------------------------------------------------------------------------

// One warp, one pass, as `tile_pass`; the warp's 16 query rows are read from
// shared memory at `Qw`; `kd` k8-steps (and output column tiles) hold the
// head's columns, all DP / 8 of them where kFull.
template <int DP, int NT, bool kExact, bool kAll, bool kFull>
__device__ __forceinline__ void tile_pass_f32(float scale_log2e, const Tile& tile, int kd,
                                              const float* Qw, const float* Kc,
                                              const float* Vc, int key0, int key_end,
                                              int steps, float (&o)[DP / 8][4],
                                              float (&m)[2], float (&l)[2]) {
  constexpr int KD = DP / 8;
  constexpr int kStride = DP + kPadF32;
  auto on = [&](int j2) { return kAll || j2 < steps; };

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    if (kFull || kk < kd) {
      uint32_t q[4], qh[4], ql[4];
      ldmatrix_x4(q, Qw + tile.a_row * kStride + kk * 8 + tile.a_col);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(q[e]), qh[e], ql[e]);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2)
        if (on(j2)) {
          // b0, b1 of the key tiles 2 j2 and 2 j2 + 1
          uint32_t kf[4], kh[4], kl[4];
          ldmatrix_x4(kf, Kc + (16 * j2 + tile.b_row) * kStride + kk * 8 + tile.b_col);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(kf[e]), kh[e], kl[e]);
          mma_3xtf32(s[2 * j2], qh, ql, kh[0], kh[1], kl[0], kl[1]);
          mma_3xtf32(s[2 * j2 + 1], qh, ql, kh[2], kh[3], kl[2], kl[3]);
        }
    }

  softmax_pass<DP, NT, kExact, kAll>(scale_log2e, tile, key0, key_end, steps, s, o, m, l);

  // PV, a k8 step per key tile j: A's columns t and t + 4 are keys 2t and
  // 2t + 1 of the tile, which this lane holds as (c0, c2) and (c1, c3)
  const int g = tile.lane / 4, t = tile.lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (on(j / 2)) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v = Vc + (8 * j + 2 * t) * kStride + g;  // b0; b1 one row on
#pragma unroll
      for (int nn = 0; nn < KD; ++nn)
        if (kFull || nn < kd) {
          uint32_t vh0, vl0, vh1, vl1;
          split_tf32(v[nn * 8], vh0, vl0);
          split_tf32(v[kStride + nn * 8], vh1, vl1);
          mma_3xtf32(o[nn], ph, pl, vh0, vh1, vl0, vl1);
        }
    }
}

// The fp32 block, as `attention_kernel`: DP is the head width rounded up to
// a multiple of 32 (or 80, flash attention's); kFull: the head width is DP.
template <typename Tag, int DP, int NT, bool kExact, bool kFull>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attention_kernel_f32(const ParamsT<float> p) {
  constexpr int kStride = DP + kPadF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [warps * kTile][kStride]
  float* Ks = Qs + warps * kTile * kStride;        // [stages][chunk][kStride]
  float* Vs = Ks + p.stages * p.chunk * kStride;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Geometry gm = geometry(p, warps, warp, lane);
  const int n_chunks = (gm.bk1 - gm.bk0 + p.chunk - 1) / p.chunk;
  const bool vec = p.vec != 0;

  const float* qb = p.q + gm.row * p.qs[0] + gm.head * p.qs[1];
  const float* kb = p.k + gm.row * p.ks[0] + gm.head * p.ks[1];
  const float* vb = p.v + gm.row * p.vs[0] + gm.head * p.vs[1];

  stage_rows_f32<DP>(Qs, qb, p.qs[2], gm.bq0, warps * kTile, gm.bq1, p.d, vec);
  stage_rows_f32<DP>(Ks, kb, p.ks[2], gm.bk0, p.chunk, gm.bk1, p.d, vec);
  stage_rows_f32<DP>(Vs, vb, p.vs[2], gm.bk0, p.chunk, gm.bk1, p.d, vec);
  cp_async_commit();

  float o[DP / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // ldmatrix row and word of this lane inside a 16 x 8 fp32 block: A (Q)
  // takes rows by lane % 16, B (K) by 8 * (lane / 16)
  const int a_row = lane % 8 + 8 * ((lane / 8) % 2), a_col = 4 * (lane / 16);
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = 4 * ((lane / 8) % 2);
  const int kd = (p.d + 7) / 8;
  float* Qw = Qs + warp * kTile * kStride;

  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) {
      const int nxt = (c + 1) & 1, k_next = gm.bk0 + (c + 1) * p.chunk;
      stage_rows_f32<DP>(Ks + nxt * p.chunk * kStride, kb, p.ks[2], k_next, p.chunk,
                         gm.bk1, p.d, vec);
      stage_rows_f32<DP>(Vs + nxt * p.chunk * kStride, vb, p.vs[2], k_next, p.chunk,
                         gm.bk1, p.d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int cs = gm.bk0 + c * p.chunk;
    const float* Kc = Ks + (c & 1) * p.chunk * kStride;
    const float* Vc = Vs + (c & 1) * p.chunk * kStride;
    int lo, hi;
    chunk_window(gm.wk0, gm.wk1, cs, p.chunk, &lo, &hi);
    if (gm.active && lo < hi) {
      const Tile tile = {gm.vis0, gm.vis1, gm.tile_vis0, gm.tile_vis1,
                         lane, a_row, a_col, b_row, b_col};
      for (int k = first_pass(lo); k < hi; k += 8 * NT) {
        int k_end;
        const int steps = pass_steps(k, hi, NT, &k_end);
        if (steps == NT / 2)
          tile_pass_f32<DP, NT, kExact, true, kFull>(p.scale_log2e, tile, kd, Qw, Kc + k * kStride,
                                              Vc + k * kStride, cs + k, cs + k_end, steps,
                                              o, m, l);
        else
          tile_pass_f32<DP, NT, kExact, false, kFull>(p.scale_log2e, tile, kd, Qw,
                                               Kc + k * kStride, Vc + k * kStride, cs + k,
                                               cs + k_end, steps, o, m, l);
      }
    }
    if (more) __syncthreads();  // this stage is refilled at the next turn
  }

  if (!gm.active) return;
  // divide by the sums, through this warp's own query rows (read for the
  // last time above), then 16-byte stores
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = row_sum_lse<kExact>(p, gm, m[r], l[r], r, lane);
    const float inv = kExact ? 1.f : 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<float2*>(Qw + (g + 8 * r) * kStride + 8 * j + 2 * t) =
          make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncwarp();
  float* ob = p.out + gm.row * p.os[0] + gm.head * p.os[1];
  const int rows = gm.wq1 - gm.wq0;
  if (vec) {
    const int chunks = p.d / 4;
    for (int idx = lane; idx < rows * chunks; idx += 32) {
      const int r = idx / chunks, c = idx - r * chunks;
      *reinterpret_cast<float4*>(ob + (long long)(gm.wq0 + r) * p.os[2] + c * 4) =
          *reinterpret_cast<const float4*>(Qw + r * kStride + c * 4);
    }
  } else {
    for (int idx = lane; idx < rows * p.d; idx += 32) {
      const int r = idx / p.d, c = idx - r * p.d;
      ob[(long long)(gm.wq0 + r) * p.os[2] + c] = Qw[r * kStride + c];
    }
  }
}

template <typename Tag, int DP, int NT, bool kExact, bool kFull>
cudaError_t launch_variant_f32(const ParamsT<float>& p, const Plan& pl,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (DP + kPadF32) *
                      ((size_t)pl.warps * kTile + 2 * (size_t)pl.stages * pl.chunk);
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel_f32<Tag, DP, NT, kExact, kFull>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)pl.blocks * p.H * p.B;
  attention_kernel_f32<Tag, DP, NT, kExact, kFull><<<grid, pl.warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename Tag, bool kAllowExact, int DP, bool kFull>
cudaError_t launch_width_f32(const ParamsT<float>& p, const Plan& pl, cudaStream_t stream) {
  if constexpr (kAllowExact) {
    if (pl.exact && pl.nt == 2) return launch_variant_f32<Tag, DP, 2, true, kFull>(p, pl, stream);
    if (pl.exact) return launch_variant_f32<Tag, DP, 10, true, kFull>(p, pl, stream);
  }
  return launch_variant_f32<Tag, DP, kOnlineChunk / 8, false, kFull>(p, pl, stream);
}

// The fp32 kernels for heads of at most DP columns: heads of exactly DP take
// the variant without the per-step width checks (at the packed kernel's
// vision shape 0.88 ms against 1.15).  Each (Tag, DP) is instantiated in a
// source file of its own (packed_attention_f32_<DP>.cu, the packed kernel's
// with the exact softmax; flash_attention_f32_<DP>.cu, flash attention's,
// online only), so that nvcc builds them side by side: in one file the
// packed kernel's took the build from 13 s to 82 s.  Flash attention also
// has DP = 80 (on the H100 its heads of 80 ran 1.4x slower through the width
// checks of DP = 96 at S = 130); DP + 4 = 84 keeps rows 16-byte aligned and
// conflict-free.
struct PackedF32 {  // the tags of those kernels
  static constexpr bool kWidth80 = false;
};
struct FlashF32 {
  static constexpr bool kWidth80 = true;
};

template <typename Tag, bool kAllowExact, int DP>
cudaError_t launch_f32_width(const ParamsT<float>& p, const Plan& pl, cudaStream_t stream) {
  if (p.d == DP) return launch_width_f32<Tag, kAllowExact, DP, true>(p, pl, stream);
  return launch_width_f32<Tag, kAllowExact, DP, false>(p, pl, stream);
}
#define LEAF_F32_WIDTH(TAG, EXACT, DP)                                                   \
  extern template cudaError_t launch_f32_width<TAG, EXACT, DP>(const ParamsT<float>&, \
                                                               const Plan&, cudaStream_t);
LEAF_F32_WIDTH(PackedF32, true, 32)
LEAF_F32_WIDTH(PackedF32, true, 64)
LEAF_F32_WIDTH(PackedF32, true, 96)
LEAF_F32_WIDTH(PackedF32, true, 128)
LEAF_F32_WIDTH(FlashF32, false, 32)
LEAF_F32_WIDTH(FlashF32, false, 64)
LEAF_F32_WIDTH(FlashF32, false, 80)
LEAF_F32_WIDTH(FlashF32, false, 96)
LEAF_F32_WIDTH(FlashF32, false, 128)
#undef LEAF_F32_WIDTH

// `launch` for fp32: any head width up to kMaxHeadDim; rows move in 16-byte
// pieces where the width, the strides and the pointers allow it, else word
// by word.  Tag and kAllowExact as in `launch`: the packed kernel's
// (PackedF32, the exact softmax allowed) or flash attention's (FlashF32,
// online only).
template <typename Tag, bool kAllowExact>
cudaError_t launch_f32(ParamsT<float> p, float scale, cudaStream_t stream) {
  if (p.B <= 0 || p.H <= 0 || p.L <= 0 || p.d <= 0 || p.d > kMaxHeadDim ||
      p.group_len <= 0)
    return cudaErrorInvalidValue;
  const Plan pl = make_plan(p.L, p.group_len, p.causal, kAllowExact, kMaxWholeChunkF32);
  if ((long long)pl.blocks * p.H * p.B > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.chunk = pl.chunk;
  p.stages = pl.stages;
  p.blocks = pl.blocks;
  p.scale_log2e = scale * 1.4426950408889634f;
  long long any = p.d;
  for (int i = 0; i < 3; ++i) any |= p.qs[i] | p.ks[i] | p.vs[i] | p.os[i];
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.out);
  p.vec = any % 4 == 0 && ptrs % 16 == 0;
  if (p.d <= 32) return launch_f32_width<Tag, kAllowExact, 32>(p, pl, stream);
  if (p.d <= 64) return launch_f32_width<Tag, kAllowExact, 64>(p, pl, stream);
  if constexpr (Tag::kWidth80)
    if (p.d <= 80) return launch_f32_width<Tag, kAllowExact, 80>(p, pl, stream);
  if (p.d <= 96) return launch_f32_width<Tag, kAllowExact, 96>(p, pl, stream);
  return launch_f32_width<Tag, kAllowExact, 128>(p, pl, stream);
}

}  // namespace mma
}  // namespace leaf
