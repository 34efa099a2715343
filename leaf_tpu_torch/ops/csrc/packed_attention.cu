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
// skipped; a query always sees itself, so no row is empty.
//
// What bounds it on the H100: at the serving shapes (L <= 257, head_dim 64) one
// (row, head) pair is at most 2 * 257 * 257 * 64 * 2 ~ 17 MFLOP over 100 KB of
// qkv, far below the tensor cores' ratio of operations to bytes: the kernel is
// bound by latency and by memory traffic, not by arithmetic.
//
// Design: one block of 8 warps per (tile of 64 queries, head, row).  The block
// stages in shared memory the K and V rows its queries can see (each row padded
// by one 32-bit word, so that lanes reading different keys hit different banks).
// Each warp then takes one query at a time: pass 1 puts its logits in shared
// memory, one key per lane, and reduces the max and the sum over the warp;
// pass 2 turns them into probabilities rounded to the dtype; the PV loop gives
// each lane its own 32-bit columns of V.  The two passes keep the JAX kernel's
// rounding points, which an online softmax would move.  Neither logits nor a
// head-major copy of q, k, v ever reach device memory.
#include <math.h>

#include "common.cuh"

namespace {

using leaf::Word;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQueryTile = 64;
constexpr int kMaxHeadDim = 128;

// keys [k0, k1) that queries [q0, q1) of one row may attend to
__host__ __device__ inline void key_range(int q0, int q1, int L, int group_len,
                                          int causal, int* k0, int* k1) {
  *k0 = (q0 / group_len) * group_len;
  int end = ((q1 - 1) / group_len + 1) * group_len;
  end = end < L ? end : L;
  if (causal && q1 < end) end = q1;
  *k1 = end;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
packed_attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int L,
                        int n_heads, int head_dim, int group_len, int causal,
                        int key_cap, float scale) {
  using W = Word<T>;
  constexpr int E = W::kElems;
  constexpr int kLaneWords = kMaxHeadDim / E / 32;  // PV columns per lane, at most

  extern __shared__ uint32_t smem[];
  const int words = head_dim / E;  // 32-bit words in one head's row
  const int stride = words + 1;    // padded row
  uint32_t* ks = smem;
  uint32_t* vs = ks + key_cap * stride;
  float* scratch = reinterpret_cast<float*>(vs + key_cap * stride);

  const int row = blockIdx.z, head = blockIdx.y;
  const int q0 = blockIdx.x * kQueryTile;
  const int q1 = min(q0 + kQueryTile, L);
  const int D = n_heads * head_dim;
  const size_t ld = (size_t)3 * D / E;  // words per token in qkv
  const uint32_t* base = reinterpret_cast<const uint32_t*>(qkv) + (size_t)row * L * ld;
  int k0, k1;
  key_range(q0, q1, L, group_len, causal, &k0, &k1);

  const int qcol = head * head_dim / E;
  const int kcol = qcol + D / E, vcol = qcol + 2 * D / E;
  for (int idx = threadIdx.x; idx < (k1 - k0) * words; idx += kThreads) {
    const int j = idx / words, w = idx - j * words;
    const uint32_t* src = base + (size_t)(k0 + j) * ld;
    ks[j * stride + w] = src[kcol + w];
    vs[j * stride + w] = src[vcol + w];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qf = scratch + warp * (head_dim + key_cap);  // this warp's query, fp32
  float* sf = qf + head_dim;                          // its logits, then probs
  uint32_t* out_words = reinterpret_cast<uint32_t*>(out);
  for (int q = q0 + warp; q < q1; q += kWarps) {
    const uint32_t* qrow = base + (size_t)q * ld + qcol;
    for (int w = lane; w < words; w += 32) W::unpack(qrow[w], qf + w * E);
    __syncwarp();

    const int gs = (q / group_len) * group_len;
    const int ge = causal ? q + 1 : min(gs + group_len, L);
    const int js = gs - k0, je = ge - k0;

    float m = -INFINITY;
    for (int j = js + lane; j < je; j += 32) {
      const uint32_t* kr = ks + j * stride;
      float dot = 0.f;
      for (int w = 0; w < words; ++w) {
        float kf[E];
        W::unpack(kr[w], kf);
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qf[w * E + e] * kf[e];
      }
      const float s = dot * scale;
      sf[j] = s;
      m = fmaxf(m, s);
    }
    m = leaf::warp_max(m);
    float l = 0.f;
    for (int j = js + lane; j < je; j += 32) l += expf(sf[j] - m);
    l = leaf::warp_sum(l);
    for (int j = js + lane; j < je; j += 32)
      sf[j] = leaf::round_to<T>(expf(sf[j] - m) / l);
    __syncwarp();

    float acc[kLaneWords][E];
#pragma unroll
    for (int i = 0; i < kLaneWords; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    for (int j = js; j < je; ++j) {
      const float p = sf[j];
      const uint32_t* vr = vs + j * stride;
#pragma unroll
      for (int i = 0; i < kLaneWords; ++i) {
        const int w = lane + 32 * i;
        if (w < words) {
          float vf[E];
          W::unpack(vr[w], vf);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] += p * vf[e];
        }
      }
    }
    uint32_t* orow = out_words + ((size_t)row * L + q) * (D / E) + qcol;
#pragma unroll
    for (int i = 0; i < kLaneWords; ++i) {
      const int w = lane + 32 * i;
      if (w < words) orow[w] = W::pack(acc[i]);
    }
    __syncwarp();  // qf and sf are rewritten for the next query
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int R, int L, int n_heads,
                   int head_dim, int group_len, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int E = Word<T>::kElems;
  if (R <= 0 || R > 65535 || L <= 0 || n_heads <= 0 || n_heads > 65535 ||
      head_dim <= 0 || head_dim > kMaxHeadDim || head_dim % E != 0 ||
      group_len <= 0)
    return cudaErrorInvalidValue;
  int key_cap = 0;
  for (int q0 = 0; q0 < L; q0 += kQueryTile) {
    const int q1 = q0 + kQueryTile < L ? q0 + kQueryTile : L;
    int k0, k1;
    key_range(q0, q1, L, group_len, causal, &k0, &k1);
    key_cap = k1 - k0 > key_cap ? k1 - k0 : key_cap;
  }
  const size_t stride = head_dim / E + 1;
  const size_t smem = 2 * key_cap * stride * sizeof(uint32_t) +
                      (size_t)kWarps * (head_dim + key_cap) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kQueryTile - 1) / kQueryTile, n_heads, R);
  packed_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), L, n_heads, head_dim,
      group_len, causal, key_cap, scale);
  return cudaGetLastError();
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
      return launch<float>(qkv, out, R, L, n_heads, head_dim, group_len, causal, scale, s);
    case leaf::kBFloat16:
      return launch<__nv_bfloat16>(qkv, out, R, L, n_heads, head_dim, group_len, causal,
                                   scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* leaf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
