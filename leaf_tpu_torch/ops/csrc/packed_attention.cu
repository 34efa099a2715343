// Block-diagonal ("packed") multi-head attention on token-major qkv, for Hopper.
//
// Replaces: leaf_tpu/ops/packed_attention.py::packed_attention (Pallas kernel
// `_kernel`), and the attention stage of `_block_kernel` in the same file; the
// fused attention block (fused_block.cu) launches this kernel as its third step.
//
// Computes, for qkv [R, L, 3D] (column blocks q | k | v, head h at columns
// h*hd .. (h+1)*hd of each block) and out [R, L, D]:
//   out[r, i, head h] = sum_j p_ij v_j,  p_ij = softmax_j(q_i . k_j * hd^-0.5)
// over the keys j of the same `group_len` block as i (and j <= i if causal).
// Numerics follow the JAX kernel: fp32 logits and softmax, the probabilities
// rounded to the input dtype before the PV product, PV accumulated in fp32 and
// rounded once.  Masked keys (weight exp(-1e30 - m) = 0 in the JAX kernel) are
// skipped; a query always sees itself, so no row is empty.  Neither logits nor
// a head-major copy of q, k, v ever reach device memory.
//
// What bounds it on the H100: at the serving shapes (L <= 257, head_dim 64) one
// (row, head) pair is at most 17 MFLOP over 130 KB of qkv and out, below the
// tensor cores' ratio of operations to bytes: the card's bound is the bytes.
//
// bf16: the tensor-core kernel of attention_mma.cuh, given q, k and v as three
// strided views of the token-major qkv.  Rows whose tiles see at most 80 keys
// (every text bucket) take its exact schedule, which keeps the JAX kernel's
// rounding points (probabilities normalised, then rounded); longer rows (the
// vision tower's 257 tokens) take the online schedule over 64-key chunks,
// because a thread would need ~135 registers for its two full logit rows: there
// the probabilities are rounded before the division by the row sum, which
// moves the result by less than one bf16 step.
//
// fp32: tensor cores would compute in TF32 (about three decimal digits), so
// fp32 keeps scalar FMAs: one block of 8 warps per (tile of 64 queries, head,
// row) stages the visible K and V rows in shared memory (rows padded by one
// word against bank conflicts); each warp takes one query at a time, logits
// through shared memory with one key per lane, the exact two-pass softmax,
// then PV with each lane on its own columns.  It is bound by the fp32 FMA rate
// and the shared-memory reads that feed it.
#include <math.h>

#include "attention_mma.cuh"

namespace {

using leaf::mma::key_range;

struct PackedTag {};  // this file's instantiations of the bf16 kernel

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueryTile = 64;
constexpr int kMaxHeadDim = 128;

__global__ void __launch_bounds__(kThreads)
packed_attention_fp32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                             int L, int n_heads, int head_dim, int group_len,
                             int causal, int key_cap, float scale) {
  constexpr int kLaneCols = kMaxHeadDim / 32;  // PV columns per lane, at most

  extern __shared__ float smem[];
  const int stride = head_dim + 1;  // padded row
  float* ks = smem;
  float* vs = ks + key_cap * stride;
  float* scratch = vs + key_cap * stride;

  const int row = blockIdx.z, head = blockIdx.y;
  const int q0 = blockIdx.x * kQueryTile;
  const int q1 = min(q0 + kQueryTile, L);
  const int D = n_heads * head_dim;
  const size_t ld = (size_t)3 * D;  // floats per token in qkv
  const float* base = qkv + (size_t)row * L * ld;
  int k0, k1;
  key_range(q0, q1, L, group_len, causal, &k0, &k1);

  const int qcol = head * head_dim;
  const int kcol = qcol + D, vcol = qcol + 2 * D;
  for (int idx = threadIdx.x; idx < (k1 - k0) * head_dim; idx += kThreads) {
    const int j = idx / head_dim, w = idx - j * head_dim;
    const float* src = base + (size_t)(k0 + j) * ld;
    ks[j * stride + w] = src[kcol + w];
    vs[j * stride + w] = src[vcol + w];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qf = scratch + warp * (head_dim + key_cap);  // this warp's query, fp32
  float* sf = qf + head_dim;                          // its logits, then probs
  for (int q = q0 + warp; q < q1; q += kWarps) {
    const float* qrow = base + (size_t)q * ld + qcol;
    for (int w = lane; w < head_dim; w += 32) qf[w] = qrow[w];
    __syncwarp();

    const int gs = (q / group_len) * group_len;
    const int ge = causal ? q + 1 : min(gs + group_len, L);
    const int js = gs - k0, je = ge - k0;

    float m = -INFINITY;
    for (int j = js + lane; j < je; j += 32) {
      const float* kr = ks + j * stride;
      float dot = 0.f;
      for (int w = 0; w < head_dim; ++w) dot += qf[w] * kr[w];
      const float s = dot * scale;
      sf[j] = s;
      m = fmaxf(m, s);
    }
    m = leaf::warp_max(m);
    float l = 0.f;
    for (int j = js + lane; j < je; j += 32) l += expf(sf[j] - m);
    l = leaf::warp_sum(l);
    for (int j = js + lane; j < je; j += 32)
      sf[j] = expf(sf[j] - m) / l;
    __syncwarp();

    float acc[kLaneCols];
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) acc[i] = 0.f;
    for (int j = js; j < je; ++j) {
      const float p = sf[j];
      const float* vr = vs + j * stride;
#pragma unroll
      for (int i = 0; i < kLaneCols; ++i) {
        const int w = lane + 32 * i;
        if (w < head_dim) acc[i] += p * vr[w];
      }
    }
    float* orow = out + ((size_t)row * L + q) * D + qcol;
#pragma unroll
    for (int i = 0; i < kLaneCols; ++i) {
      const int w = lane + 32 * i;
      if (w < head_dim) orow[w] = acc[i];
    }
    __syncwarp();  // qf and sf are rewritten for the next query
  }
}

cudaError_t launch_fp32(const float* qkv, float* out, int R, int L, int n_heads,
                        int head_dim, int group_len, int causal, float scale,
                        cudaStream_t stream) {
  if (R <= 0 || R > 65535 || L <= 0 || n_heads <= 0 || n_heads > 65535 ||
      head_dim <= 0 || head_dim > kMaxHeadDim || group_len <= 0)
    return cudaErrorInvalidValue;
  int key_cap = 0;
  for (int q0 = 0; q0 < L; q0 += kQueryTile) {
    const int q1 = q0 + kQueryTile < L ? q0 + kQueryTile : L;
    int k0, k1;
    key_range(q0, q1, L, group_len, causal, &k0, &k1);
    key_cap = k1 - k0 > key_cap ? k1 - k0 : key_cap;
  }
  const size_t stride = head_dim + 1;
  const size_t smem = sizeof(float) * (2 * key_cap * stride +
                                       (size_t)kWarps * (head_dim + key_cap));
  cudaError_t err =
      cudaFuncSetAttribute(packed_attention_fp32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kQueryTile - 1) / kQueryTile, n_heads, R);
  packed_attention_fp32_kernel<<<grid, kThreads, smem, stream>>>(
      qkv, out, L, n_heads, head_dim, group_len, causal, key_cap, scale);
  return cudaGetLastError();
}

// q, k and v are views of qkv: token stride 3D, head stride head_dim
cudaError_t launch_bf16(const __nv_bfloat16* qkv, __nv_bfloat16* out, int R, int L,
                        int n_heads, int head_dim, int group_len, int causal,
                        float scale, cudaStream_t stream) {
  const long long D = (long long)n_heads * head_dim;
  leaf::mma::Params p = {};
  p.q = qkv;
  p.k = qkv + D;
  p.v = qkv + 2 * D;
  p.out = out;
  const long long in[3] = {L * 3 * D, head_dim, 3 * D}, to[3] = {L * D, head_dim, D};
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = p.ks[i] = p.vs[i] = in[i];
    p.os[i] = to[i];
  }
  p.B = R;
  p.H = n_heads;
  p.L = L;
  p.d = head_dim;
  p.group_len = group_len;
  p.causal = causal;
  return leaf::mma::launch<PackedTag, /*kAllowExact=*/true>(p, scale, stream);
}

}  // namespace

extern "C" int leaf_packed_attention(const void* qkv, void* out, int dtype, int R,
                                     int L, int n_heads, int head_dim, int group_len,
                                     int causal, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case leaf::kFloat32:
      return launch_fp32(static_cast<const float*>(qkv), static_cast<float*>(out), R, L,
                         n_heads, head_dim, group_len, causal, scale, s);
    case leaf::kBFloat16:
      return launch_bf16(static_cast<const __nv_bfloat16*>(qkv),
                         static_cast<__nv_bfloat16*>(out), R, L, n_heads, head_dim,
                         group_len, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The schedule of the bf16 attention kernels for one row of L tokens, computed
// on the host and launching nothing: plan = {warps, blocks, chunk, stages, nt,
// exact} of `make_plan`, passes = `list_passes` triples; returns the number of
// passes, or -1 if there are more than `cap`.
extern "C" int leaf_attention_schedule(int L, int group_len, int causal, int allow_exact,
                                       int* plan, int* passes, int cap) {
  if (L <= 0 || group_len <= 0) return -1;
  const leaf::mma::Plan pl = leaf::mma::make_plan(L, group_len, causal, allow_exact != 0);
  const int fields[6] = {pl.warps, pl.blocks, pl.chunk, pl.stages, pl.nt, pl.exact};
  for (int i = 0; i < 6; ++i) plan[i] = fields[i];
  return leaf::mma::list_passes(L, group_len, causal, pl, passes, cap);
}

extern "C" const char* leaf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
