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
// tensor cores' ratio of operations to bytes: in bf16 the card's bound is the
// bytes.  In fp32 each product is three TF32 products (3xTF32), at ~165
// TFLOP/s: the vision rows' bound is their operations, the text rows' still
// their bytes.
//
// Both dtypes run the tensor-core kernel of attention_mma.cuh, given q, k and
// v as three strided views of the token-major qkv.
//   * bf16: rows whose tiles see at most 80 keys (every text bucket) take its
//     exact schedule, which keeps the JAX kernel's rounding points
//     (probabilities normalised, then rounded); longer rows (the vision
//     tower's 257 tokens) take the online schedule over 64-key chunks,
//     because a thread would need ~135 registers for its two full logit rows:
//     there the probabilities are rounded before the division by the row sum,
//     which moves the result by less than one bf16 step.
//   * fp32: the same schedules on `mma.sync.m16n8k8` TF32 with every operand
//     split into hi + lo (fp32 accuracy: held to 1e-4 where one TF32 pass is
//     off by ~1e-3), the JAX kernel's fp32 numerics otherwise: fp32 logits
//     times hd^-0.5, fp32 softmax (exp2 of prescaled logits), fp32
//     probabilities into PV, masked keys skipped.  A block stages at most 144
//     keys whole (fp32 rows take twice the bytes); longer ranges (the vision
//     rows, SigLIP-384's 729 tokens) go through the ring of two 64-key
//     stages, so no row is read in place from global memory.
#include "attention_mma.cuh"

namespace {

struct PackedTag {};  // this file's instantiations of the bf16 attention kernels

// q, k and v are views of qkv: token stride 3D, head stride head_dim
template <typename T>
leaf::mma::ParamsT<T> views(const T* qkv, T* out, int R, int L, int n_heads, int head_dim,
                            int group_len, int causal) {
  const long long D = (long long)n_heads * head_dim;
  leaf::mma::ParamsT<T> p = {};
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
  return p;
}

}  // namespace

// out [R, L, D] from qkv [R, L, 3D]; where `lse` is not null, also each
// query's log-sum-exp (natural log, fp32 [R, n_heads, L]) for the backward
// kernels (attention_backward.cu).  Serving passes none.
extern "C" int leaf_packed_attention(const void* qkv, void* out, void* lse, int dtype, int R,
                                     int L, int n_heads, int head_dim, int group_len,
                                     int causal, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case leaf::kFloat32: {
      auto p = views(static_cast<const float*>(qkv), static_cast<float*>(out), R, L, n_heads,
                     head_dim, group_len, causal);
      p.lse = static_cast<float*>(lse);
      return leaf::mma::launch_f32<leaf::mma::PackedF32, /*kAllowExact=*/true>(p, scale, s);
    }
    case leaf::kBFloat16: {
      auto p = views(static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
                     R, L, n_heads, head_dim, group_len, causal);
      p.lse = static_cast<float*>(lse);
      return leaf::mma::launch<PackedTag, /*kAllowExact=*/true>(p, scale, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// The schedule of the tensor-core attention kernels for one row of L tokens in
// `dtype` (fp32's blocks stage fewer keys whole), computed on the host and
// launching nothing: plan = {warps, blocks, chunk, stages, nt, exact} of
// `make_plan`, passes = `list_passes` triples; returns the number of passes,
// or -1 if there are more than `cap`.
extern "C" int leaf_attention_schedule(int L, int group_len, int causal, int allow_exact,
                                       int dtype, int* plan, int* passes, int cap) {
  if (L <= 0 || group_len <= 0) return -1;
  if (dtype != leaf::kFloat32 && dtype != leaf::kBFloat16) return -1;
  const int max_whole =
      dtype == leaf::kFloat32 ? leaf::mma::kMaxWholeChunkF32 : leaf::mma::kMaxWholeChunk;
  const leaf::mma::Plan pl =
      leaf::mma::make_plan(L, group_len, causal, allow_exact != 0, max_whole);
  const int fields[6] = {pl.warps, pl.blocks, pl.chunk, pl.stages, pl.nt, pl.exact};
  for (int i = 0; i < 6; ++i) plan[i] = fields[i];
  return leaf::mma::list_passes(L, group_len, causal, pl, passes, cap);
}

extern "C" const char* leaf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
