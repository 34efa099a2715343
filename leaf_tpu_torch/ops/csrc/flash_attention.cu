// Flash attention forward (online softmax over tiles of keys), for Hopper.
//
// Replaces: leaf_tpu/ops/flash_attention.py::flash_attention (Pallas kernel
// `_attn_kernel`, called from `_flash_forward`), and through it `mha_with_flash`.
//
// Computes, for q, k, v [B*H, S, d] (one contiguous [S, d] matrix per batch and
// head) and out of the same shape:
//   out_i = sum_j p_ij v_j,  p_ij = softmax_j((q_i * scale) . k_j)
// over keys j < S (and j <= i if causal).  Numerics follow the JAX kernel: q is
// scaled in fp32, logits, the running max m, the running sum l and the output
// accumulator stay fp32, the probabilities enter the PV product in fp32 (they
// are not rounded to the input dtype, unlike the packed kernel's), masked
// logits are the finite -1e30, and the result acc / max(l, 1e-30) is rounded
// once to the input dtype.
//
// What bounds it on the H100: one (batch, head) pair at the ViT-L vision shape
// (S = 257, d = 64) is 4 * 257 * 257 * 64 ~ 17 MFLOP over 4 * 257 * 64 * 2 ~
// 130 KB of q, k, v and out: ~130 operations per byte, below the bf16 tensor
// cores' ratio (~295), so the card's bound is the bytes.  This kernel does its
// products with fp32 FMAs outside the tensor cores and is bound by those
// (67 TFLOP/s at best) and by the shared-memory reads that feed them.
//
// Design: one block of 256 threads per (batch*head, tile of 64 queries), where
// the TPU kernel pads S to 128 lanes and keeps a whole padded K/V in VMEM.  The
// block loops over tiles of 64 keys, staging K and V in shared memory as fp32
// (tails past S are zero-filled and masked, never padded in device memory) and
// skipping the key tiles a causal query tile cannot see.  Threads form a 16 x 16
// grid: thread (ty, tx) owns query rows 4*ty .. 4*ty+3; for QK^T it owns keys
// tx, tx+16, tx+32, tx+48 of the tile (a 4 x 4 register tile, operands read as
// float4 along d; K rows are padded by 4 floats so a quarter-warp's float4 reads
// hit distinct banks), and for PV the float4 output columns tx and tx+16 of the
// same rows.  Row maxima and sums are reduced over the 16 lanes that share a
// row with shuffles, so m and l live in registers; the probabilities cross from
// the QK^T layout to the PV layout through a 64 x 64 fp32 tile in shared memory.
// No logits, probabilities or padded copies reach device memory.
#include <math.h>

#include "common.cuh"

namespace {

using leaf::Word;

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // queries per block
constexpr int kBK = 64;              // keys per staged tile
constexpr int kRows = 4;             // query rows per thread (kBQ / 16)
constexpr int kKeys = 4;             // keys per thread in a tile (kBK / 16)
constexpr int kMaxHeadDim = 128;
constexpr int kMaxVec = kMaxHeadDim / 4 / 16;  // float4 output columns per thread
constexpr int kPStride = kBK + 4;    // row stride of the probability tile
constexpr float kNegInf = -1e30f;    // the JAX kernel's finite mask value

template <typename T> __device__ __forceinline__ void load4(const T* p, float* f);
template <> __device__ __forceinline__ void load4<float>(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  Word<__nv_bfloat16>::unpack(v.x, f);
  Word<__nv_bfloat16>::unpack(v.y, f + 2);
}

template <typename T> __device__ __forceinline__ void store4(T* p, const float* f);
template <> __device__ __forceinline__ void store4<float>(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                                  const float* f) {
  uint2 v;
  v.x = Word<__nv_bfloat16>::pack(f);
  v.y = Word<__nv_bfloat16>::pack(f + 2);
  *reinterpret_cast<uint2*>(p) = v;
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

// rows [r0, r0 + rows) of a [S, d] matrix -> fp32 shared memory with row stride
// `stride`, times `scale`; rows past S are zero
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst, int r0,
                                      int rows, int S, int d, int stride, float scale) {
  const int vecs = d / 4;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int r = idx / vecs, c = (idx - r * vecs) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load4<T>(src + (size_t)(r0 + r) * d + c, f);
    *reinterpret_cast<float4*>(dst + r * stride + c) =
        make_float4(f[0] * scale, f[1] * scale, f[2] * scale, f[3] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int d,
                       int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kstride = d + 4;
  float* Qs = smem;                // [kBQ][d], scaled
  float* Ks = Qs + kBQ * d;        // [kBK][d + 4]
  float* Vs = Ks + kBK * kstride;  // [kBK][d]
  float* Ps = Vs + kBK * d;        // [kBQ][kPStride]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * kBQ;
  const size_t base = (size_t)blockIdx.x * S * d;
  const int vecs = d / 4;

  stage<T>(q + base, Qs, q0, kBQ, S, d, d, scale);

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
    stage<T>(k + base, Ks, k0, kBK, S, d, kstride, 1.f);
    stage<T>(v + base, Vs, k0, kBK, S, d, d, 1.f);
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
        store4<T>(out + base + (size_t)qg * d + c4 * 4, o);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH,
                   int S, int d, int causal, float scale, cudaStream_t stream) {
  if (BH <= 0 || S <= 0 || d <= 0 || d > kMaxHeadDim || d % 8 != 0)
    return cudaErrorInvalidValue;
  const int q_tiles = (S + kBQ - 1) / kBQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * d + (size_t)kBK * (d + 4) + (size_t)kBK * d +
                       (size_t)kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, q_tiles);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, d, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int leaf_flash_attention(const void* q, const void* k, const void* v,
                                    void* out, int dtype, int BH, int S, int d,
                                    int causal, float scale, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case leaf::kFloat32:
      return launch<float>(q, k, v, out, BH, S, d, causal, scale, s);
    case leaf::kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, out, BH, S, d, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
