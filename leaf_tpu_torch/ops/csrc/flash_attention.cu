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
// bound is the bytes.
//
// bf16: the tensor-core kernel of attention_mma.cuh in its online schedule
// (one group of S keys, chunks of 64 keys, double buffered).  One deviation
// from the JAX kernel, forced by the tensor cores: the JAX kernel widens q, k
// and v to fp32, scales q and keeps the probabilities fp32 into PV; here q and
// k enter the product as bf16, the scale multiplies the fp32 logits after it (a
// head of 80 has a scale that is no power of two), and the probabilities are
// rounded to bf16 for PV, which is what the plain version beside the wrapper
// does.
//
// fp32: tensor cores would compute in TF32 (about three decimal digits), so
// fp32 keeps the JAX kernel's arithmetic (q scaled first, fp32 probabilities
// into PV, the finite mask value -1e30) in scalar FMAs, and is bound by their
// rate (67 TFLOP/s at best) and the shared-memory reads that feed them.  One
// block of 256 threads per (batch, head, tile of 64 queries) loops over tiles
// of 64 keys staged in shared memory (tails past S zero-filled and masked).
// Threads form a 16 x 16 grid: thread (ty, tx) owns query rows 4*ty .. 4*ty+3;
// for QK^T it owns keys tx, tx+16, tx+32, tx+48 of the tile (a 4 x 4 register
// tile, float4 reads along d; K rows padded by 4 floats against bank
// conflicts), for PV the float4 output columns tx and tx+16 of the same rows.
// Row maxima and sums cross the 16 lanes of a row by shuffle; the
// probabilities go from the QK^T layout to the PV layout through a 64 x 64
// tile in shared memory.  No logits or padded copies reach device memory.
#include <math.h>

#include "attention_mma.cuh"

namespace {

struct FlashTag {};  // this file's instantiations of the bf16 kernel

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // queries per block
constexpr int kBK = 64;              // keys per staged tile
constexpr int kRows = 4;             // query rows per thread (kBQ / 16)
constexpr int kKeys = 4;             // keys per thread in a tile (kBK / 16)
constexpr int kMaxHeadDim = 128;
constexpr int kMaxVec = kMaxHeadDim / 4 / 16;  // float4 output columns per thread
constexpr int kPStride = kBK + 4;    // row stride of the probability tile
constexpr float kNegInf = -1e30f;    // the JAX kernel's finite mask value

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// reductions over the 16 consecutive lanes that share a query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + rows) of an [S, d] matrix whose rows lie `ld` floats apart ->
// shared memory with row stride `stride`, times `scale`; rows past S are zero
__device__ __forceinline__ void stage(const float* __restrict__ src, long long ld,
                                      float* dst, int r0, int rows, int S, int d,
                                      int stride, float scale) {
  const int vecs = d / 4;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int r = idx / vecs, c = (idx - r * vecs) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load4(src + (r0 + r) * ld + c, f);
    *reinterpret_cast<float4*>(dst + r * stride + c) =
        make_float4(f[0] * scale, f[1] * scale, f[2] * scale, f[3] * scale);
  }
}

// strides: (batch, head, token) of q, k, v and out, in floats
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

__global__ void __launch_bounds__(kThreads)
flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ out,
                            const Strides st, int H, int S, int d, int causal,
                            float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kstride = d + 4;
  float* Qs = smem;                // [kBQ][d], scaled
  float* Ks = Qs + kBQ * d;        // [kBK][d + 4]
  float* Vs = Ks + kBK * kstride;  // [kBK][d]
  float* Ps = Vs + kBK * d;        // [kBQ][kPStride]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * kBQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  q += b * st.q[0] + h * st.q[1];
  k += b * st.k[0] + h * st.k[1];
  v += b * st.v[0] + h * st.v[1];
  out += b * st.o[0] + h * st.o[1];
  const int vecs = d / 4;

  stage(q, st.q[2], Qs, q0, kBQ, S, d, d, scale);

  float m[kRows], l[kRows], acc[kRows][kMaxVec][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxVec; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;
  }

  // a causal query tile sees no key at or past its own end
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    stage(k, st.k[2], Ks, k0, kBK, S, d, kstride, 1.f);
    stage(v, st.v[2], Vs, k0, kBK, S, d, d, 1.f);
    __syncthreads();

    // logits of this thread's 4 rows x 4 keys
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < d; dd += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * kRows + i) * d + dd);
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kstride + dd);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }

    // mask, then the online-softmax update of m, l and acc
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qg = q0 + ty * kRows + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kg = k0 + tx + 16 * j;
        const bool visible = kg < S && (!causal || kg <= qg);
        s[i][j] = visible ? s[i][j] : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mc));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * kRows + i) * kPStride + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kMaxVec; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] *= alpha;
    }
    __syncthreads();

    // acc += P V for this thread's 4 rows and its float4 columns
    for (int kk = 0; kk < kBK; kk += 4) {
      float pa[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (ty * kRows + i) * kPStride + kk);
        pa[i][0] = pv.x; pa[i][1] = pv.y; pa[i][2] = pv.z; pa[i][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < kMaxVec; ++jj) {
        const int c4 = tx + 16 * jj;
        if (c4 < vecs) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float4 vv =
                *reinterpret_cast<const float4*>(Vs + (kk + t) * d + c4 * 4);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              acc[i][jj][0] += pa[i][t] * vv.x;
              acc[i][jj][1] += pa[i][t] * vv.y;
              acc[i][jj][2] += pa[i][t] * vv.z;
              acc[i][jj][3] += pa[i][t] * vv.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qg = q0 + ty * kRows + i;
    if (qg >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kMaxVec; ++jj) {
      const int c4 = tx + 16 * jj;
      if (c4 < vecs) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = acc[i][jj][e] / denom;
        *reinterpret_cast<float4*>(out + qg * st.o[2] + c4 * 4) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

cudaError_t launch_fp32(const float* q, const float* k, const float* v, float* out,
                        const Strides& st, int B, int H, int S, int d, int causal,
                        float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S <= 0 || d <= 0 || d > kMaxHeadDim || d % 8 != 0)
    return cudaErrorInvalidValue;
  const int q_tiles = (S + kBQ - 1) / kBQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * d + (size_t)kBK * (d + 4) + (size_t)kBK * d +
                       (size_t)kBQ * kPStride);
  cudaError_t err =
      cudaFuncSetAttribute(flash_attention_fp32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, q_tiles);
  flash_attention_fp32_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, st, H, S,
                                                                d, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, __nv_bfloat16* out, const Strides& st,
                        int B, int H, int S, int d, int causal, float scale,
                        cudaStream_t stream) {
  leaf::mma::Params p = {};
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
  p.group_len = S;  // one group: ordinary attention
  p.causal = causal;
  return leaf::mma::launch<FlashTag, /*kAllowExact=*/false>(p, scale, stream);
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
      return launch_fp32(static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<float*>(out), st, B,
                         H, S, d, causal, scale, s);
    case leaf::kBFloat16:
      return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<__nv_bfloat16*>(out), st, B, H, S, d, causal,
                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
