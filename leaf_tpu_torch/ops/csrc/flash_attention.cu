// Flash attention forward (online softmax over tiles of keys), for Hopper.
//
// Replaces: leaf_tpu/ops/flash_attention.py::flash_attention (Pallas kernel
// `_attn_kernel`, called from `_flash_forward`), and through it `mha_with_flash`.
//
// Computes, for q, k, v and out [B, H, S, d], each given with its strides for
// batch, head and token (the head width is dense), so that views of a fused
// token-major qkv are read in place:
//   out_i = sum_j p_ij v_j,  p_ij = softmax_j(q_i . k_j * scale)
// over keys j < S (and j <= i if causal): logits, the running max m, the
// running sum l and the output accumulator stay fp32, key tiles past the
// causal diagonal are skipped, and acc / max(l, 1e-30) is rounded once.
//
// What bounds it on the H100: one (batch, head) pair at the ViT-L vision shape
// (S = 257, d = 64) is 17 MFLOP over 130 KB of q, k, v and out: ~130
// operations per byte, below the bf16 tensor cores' ratio (~295), so the card's
// bound in bf16 is the bytes.  In fp32 each product is three TF32 products
// (3xTF32, ~165 TFLOP/s): the vision shape is bound by its operations, the
// text shapes (S <= 77) still by their bytes.
//
// Both dtypes run the tensor-core kernel of attention_mma.cuh in its online
// schedule (one group of S keys, passes of 64 keys), given q, k, v and out as
// strided views; flash attention has kernels of its own (FlashTag in bf16,
// FlashF32 in fp32), so that a trace tells them from the packed kernel's.
//
// bf16: one deviation from the JAX kernel, forced by the tensor cores: the JAX
// kernel widens q, k and v to fp32, scales q and keeps the probabilities fp32
// into PV; here q and k enter the product as bf16, the scale multiplies the
// fp32 logits after it (a head of 80 has a scale that is no power of two), and
// the probabilities are rounded to bf16 for PV, which is what the plain version
// beside the wrapper does.
//
// fp32: 3xTF32 `mma.sync.m16n8k8` (every operand split into hi + lo as it is
// loaded: fp32 accuracy, held to 1e-4 where one TF32 pass is off by ~1e-3),
// the probabilities fp32 into PV, as in the JAX kernel.  The body keeps the
// core's order, not the JAX kernel's: the scale multiplies the fp32 logits
// after the product (the JAX kernel scales q before it), and masked keys get
// -inf (the JAX kernel's finite -1e30); no row has every key masked (a causal
// query sees itself), so both give the same probabilities, and the two orders
// of the scale differ by an ulp of a logit, far inside 1e-4.  A block stages
// at most 144 keys whole (the text shapes); longer rows (the vision shape's
// 257) go through the core's ring of two 64-key stages.  The kernels per
// head width (32, 64, 80, 96, 128: heads of 80 take one of their own, with
// no width checks in its loops) are in flash_attention_f32_<DP>.cu.  What
// holds the fp32 body at short rows (S = 130, heads of 80) is occupancy:
// the query tile and K and V of 144 fp32 keys take 124 KB of shared memory,
// so an SM runs one block of 5 warps, too few to hide the tensor cores'
// latency.
// No logits or padded copies reach device memory.
#include "attention_mma.cuh"

namespace {

struct FlashTag {};  // this file's instantiations of the bf16 kernel

// strides: (batch, head, token) of q, k, v and out, in elements
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// the core's parameters: one group of S keys (ordinary attention)
template <typename T>
leaf::mma::ParamsT<T> params(const T* q, const T* k, const T* v, T* out, const Strides& st,
                             int B, int H, int S, int d, int causal) {
  leaf::mma::ParamsT<T> p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = st.q[i];
    p.ks[i] = st.k[i];
    p.vs[i] = st.v[i];
    p.os[i] = st.o[i];
  }
  p.B = B;
  p.H = H;
  p.L = S;
  p.d = d;
  p.group_len = S;
  p.causal = causal;
  return p;
}

}  // namespace
// strides: 12 element strides, (batch, head, token) of q, then k, v, out
extern "C" int leaf_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, const long long* strides, int dtype,
                                    int B, int H, int S, int d, int causal,
                                    float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  switch (dtype) {
    case leaf::kFloat32:
      if (d % 8 != 0) return cudaErrorInvalidValue;
      return leaf::mma::launch_f32<leaf::mma::FlashF32, /*kAllowExact=*/false>(
          params(static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(out), st, B, H, S, d,
                 causal),
          scale, s);
    case leaf::kBFloat16:
      return leaf::mma::launch<FlashTag, /*kAllowExact=*/false>(
          params(static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), st,
                 B, H, S, d, causal),
          scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
