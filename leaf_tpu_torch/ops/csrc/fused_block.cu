// The fused attention block for Hopper: LayerNorm, GEMM + bias (+ residual)
// and the launcher that runs the whole block from one call.
//
// Replaces: leaf_tpu/ops/packed_attention.py::fused_attention_block (Pallas
// kernel `_block_kernel`), which computes x + out_proj(attn(qkv_proj(LN_1(x))))
// with the 3D^2 + D^2 weights resident in TPU VMEM.  At D = 1024 those weights
// are 8 MiB in bf16, and a Hopper block has 227 KB of shared memory, so the
// block is four kernels that `leaf_fused_block` launches in order on one
// stream:
//   1. layer_norm.cu:     h = LN_1(x), fp32 statistics, written in x.dtype;
//   2. gemm_bias:         qkv = h @ qkv_w + qkv_b;
//   3. packed_attention.cu: attn = packed attention over qkv;
//   4. gemm_bias:         out = x + (attn @ out_w + out_b).
// `leaf_layer_norm` (layer_norm.cu) and `leaf_gemm_bias` launch 1 and 2/4
// alone (the LayerNorm op of every other LayerNorm in the towers, and the
// profiler).
//
// Weight layout: W is [K, N] row-major, y = x @ W (the JAX package's layout).
// OpenCLIP's in_proj_weight [3D, D] is transposed once when a checkpoint is
// converted (models/interop.py), never at run time.
//
// Rounding points, as in the JAX kernel: LN in fp32, result rounded to the
// dtype; GEMMs accumulate in fp32; the bias is stored in the dtype and added
// in fp32 before the one rounding of the product; the residual add is a sum of
// two dtype values, rounded to the dtype.
//
// What bounds it on the H100.  The two GEMMs are bound by the tensor cores
// (M = R*L tokens of 4,096..102,400 per call, K = D, N = 3D or D), but not by
// much: at K = 768 writing a 128 x 256 output tile takes a third of the time of
// its products, so that write must overlap the next tile's products.  In fp32
// each product is three TF32 products (3xTF32, ~165 TFLOP/s at most: 495 / 3),
// still well above the 67 TFLOP/s of fp32 FMAs, and the GEMMs stay bound by
// their operations.  LayerNorm reads and writes each activation once and is
// bound by memory bandwidth (layer_norm.cu says how it gets near it).
//
// Design:
//   * bf16 GEMM (`gemm_bias_wgmma_kernel`): one persistent block per SM walks
//     the output tiles (N fastest, so that the blocks running together share
//     their rows of A in L2).  A tile is 128 x BN, BN in {256, 192, 128}
//     picked on the host so that the tiles fill the SMs in whole waves.
//     Roles, by warp, with no block-wide barrier after the set-up:
//       - a loader thread keeps a ring of (A tile, W tile) stages of 64 k
//         filled by TMA (128-byte swizzle; rows past M, N or K arrive as
//         zeros), `mbarrier`s `full`/`empty` per stage;
//       - two consumer warpgroups of 64 rows each issue `wgmma` m64nBNk16
//         from shared memory into register accumulators and hand a stage
//         back when the products that read it have retired; W stays [K, N]:
//         it is the MN-major B operand (see wgmma.cuh).  Their epilogue adds
//         the bias in registers, rounds, and writes the tile into a staging
//         tile in shared memory (the layout of 64 x 64 TMA boxes), adding
//         the residual it finds there; then they start the next tile;
//       - a storer thread TMA-loads a tile's residual into the staging tile
//         while its products run, and TMA-stores the finished tile (rows and
//         columns past M and N are dropped), so that the write to global
//         memory overlaps the next tile's products.
//     The producers give their registers to the consumers (`setmaxnreg`).
//   * fp32 GEMM (`gemm_bias_tf32_wgmma_kernel`): 3xTF32 (common.cuh: every
//     operand split into hi + lo, fp32 accuracy, held to 1e-4 where one TF32
//     pass is off by ~1e-3) on `wgmma`.  TF32 `wgmma` takes no transposed
//     operand, and W [K, N] is N-major, so the kernel computes
//     out^T = W^T A^T: W^T is the A operand, 64 rows (columns n of out) a
//     warpgroup, from registers, loaded from shared memory in mma.m16n8k8's
//     fragment layout and split as it is loaded (rows of W padded to 8 (mod
//     32) words: 32 loads in 32 banks); the activations [M, K] are the
//     K-major B operand, 128 rows (m) of 32 k a stage in 128-byte swizzled
//     rows, split once a block into a hi tile (in place) and a lo tile.  A
//     ring of 4 stages filled by 16-byte `cp.async` (zero-filled past M, N
//     and K; N and K multiples of 4); the split of stage k + 1 and the copy
//     of stage k + 3 run while stage k's products do.  Each stage's
//     products go to a fresh accumulator that is then added to the total in
//     fp32: the tensor core truncates every sum it accumulates, and into the
//     total that lost ~5e-5 at K = 1024 and ~8e-5 at K = 1664, ~1e-5 this
//     way.  The epilogue adds the bias in fp32, then the residual.  An
//     `mma.sync.m16n8k8` version (8 warps of 64 x 32, both operands split
//     in registers) ran the eval's qkv GEMM in 3.65 ms against this one's
//     2.83: it issued ~3.7 other instructions a TF32 product.
#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

extern "C" int leaf_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                               int dtype, int M, int D, float eps, int device, void* stream);
extern "C" int leaf_packed_attention(const void* qkv, void* out, void* lse, int dtype, int R,
                                     int L, int n_heads, int head_dim, int group_len,
                                     int causal, float scale, int device, void* stream);

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 GEMM + bias (+ residual): TMA ring, wgmma, persistent tiles
// ---------------------------------------------------------------------------

namespace hp = leaf::hopper;

constexpr int kBM = 128;         // rows of a tile: 64 per consumer warpgroup
constexpr int kBK = 64;          // k per stage: one 128-byte swizzled row of bf16
constexpr int kConsumerWarps = 8;
// + the producer warpgroup: two of its lanes (the loader, the storer) issue
// every copy; the rest is there so that the warpgroup can hand its registers
// over (`setmaxnreg` moves registers between whole warpgroups)
constexpr int kGemmThreads = (kConsumerWarps + 4) * 32;
// 384 threads start with 168 registers each; the producers keep 40 and each
// consumer takes 232 (128 x 40 + 256 x 232 = 64,512): the 256-wide tile's 128
// accumulators and its epilogue do not fit in 168
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBoxBytes = 64 * 64 * 2;  // a [64, 64] TMA box: 64 k of W, 64 rows of the output
constexpr int kSmemLimit = 227 * 1024;

template <int BN> struct GemmTile {
  static constexpr int kStageBytes = kABytes + BN / 64 * kBoxBytes;
  // the output tile, as [64 rows, 64 cols] boxes: warpgroup 0's, then 1's
  static constexpr int kStagingBytes = kBM * BN * 2;
  // as many stages as fit beside it, the barriers and the 1024-byte alignment
  static constexpr int kFit = (kSmemLimit - 2048 - kStagingBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmemBytes = kStages * kStageBytes + kStagingBytes + 2048;
};

template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_bias_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_residual,
                       const __grid_constant__ CUtensorMap map_out,
                       const bf16* __restrict__ bias, int has_residual, int M, int N,
                       int K) {
  using Tile = GemmTile<BN>;
  constexpr int kStages = Tile::kStages;
  constexpr int kBoxes = BN / 64;  // boxes of 64 columns across the tile
  extern __shared__ uint8_t smem_raw[];
  // stages and the staging tile (1024-byte aligned: the swizzle atom), then
  // the barriers
  const uint32_t stages = (hp::smem_address(smem_raw) + 1023u) & ~1023u;
  const uint32_t staging = stages + kStages * Tile::kStageBytes;
  const uint32_t full = staging + Tile::kStagingBytes;
  const uint32_t empty = full + kStages * 8;
  const uint32_t staging_ready = empty + kStages * 8;  // free, and holds the residual
  const uint32_t staging_written = staging_ready + 8;  // holds the finished tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbarrier_init(full + s * 8, 1);                // the loader's expect_tx
      hp::mbarrier_init(empty + s * 8, kConsumerWarps);  // one arrival per consumer warp
    }
    hp::mbarrier_init(staging_ready, 1);
    hp::mbarrier_init(staging_written, kConsumerWarps);
    hp::mbarrier_init_fence();
  }
  __syncthreads();

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + kBM - 1) / kBM * tiles_n;
  const int k_steps = (K + kBK - 1) / kBK;

  if (warp >= kConsumerWarps) {
    // ---- the producer warpgroup: two of its lanes issue every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (lane != 0) return;
    if (warp == kConsumerWarps) {
      // the loader: keeps the ring of (A, W) stages full
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          const uint32_t bar = full + stage * 8, dst = stages + stage * Tile::kStageBytes;
          hp::mbarrier_wait(empty + stage * 8, phase ^ 1);  // passes at once the first time
          hp::mbarrier_arrive_expect_tx(bar, Tile::kStageBytes);
          hp::tma_load_2d(dst, &map_a, bar, ks * kBK, m0);
#pragma unroll
          for (int c = 0; c < kBoxes; ++c)
            hp::tma_load_2d(dst + kABytes + c * kBoxBytes, &map_w, bar, n0 + c * 64,
                            ks * kBK);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (warp == kConsumerWarps + 1) {
      // the storer: brings a tile's residual into the staging tile while its
      // products run, and sends the finished tile to global memory
      uint32_t parity = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, parity ^= 1) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
        hp::tma_store_wait<false>();  // the tile before has left the staging tile
        if (has_residual) {
          hp::mbarrier_arrive_expect_tx(staging_ready, Tile::kStagingBytes);
          for (int b = 0; b < 2 * kBoxes; ++b)
            hp::tma_load_2d(staging + b * kBoxBytes, &map_residual, staging_ready,
                            n0 + b % kBoxes * 64, m0 + b / kBoxes * 64);
        } else {
          hp::mbarrier_arrive(staging_ready);
        }
        hp::mbarrier_wait(staging_written, parity);
        for (int b = 0; b < 2 * kBoxes; ++b) {
          const int row = m0 + b / kBoxes * 64, col = n0 + b % kBoxes * 64;
          if (row < M && col < N) hp::tma_store_2d(&map_out, staging + b * kBoxBytes, col, row);
        }
        hp::tma_store_commit();
      }
      hp::tma_store_wait<true>();  // the shared memory must outlive the stores
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int quad = lane % 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0, tile_parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, tile_parity ^= 1) {
    const int n0 = tile % tiles_n * BN;
    int last = 0;
    for (int ks = 0; ks < k_steps; ++ks) {
      const uint32_t a = stages + stage * Tile::kStageBytes + wg * 64 * 128;
      const uint32_t w = stages + stage * Tile::kStageBytes + kABytes;
      hp::mbarrier_wait(full + stage * 8, phase);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hp::Wgmma<BN>::mma(acc, hp::matrix_descriptor(a + kk * 32, 16, 1024),
                           hp::matrix_descriptor(w + kk * 16 * 128, kBoxBytes, 1024),
                           (ks | kk) != 0);
      hp::wgmma_commit();
      if (ks > 0) {  // the products of the stage before have retired: hand it back
        hp::wgmma_wait<1>();
        if (lane == 0) hp::mbarrier_arrive(empty + last * 8);
      }
      last = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hp::wgmma_wait<0>();
    if (lane == 0) hp::mbarrier_arrive(empty + last * 8);
    hp::fence_registers(acc);

    // ---- epilogue: registers -> the staging tile, in the layout of the TMA
    // boxes (128-byte rows, 16-byte pieces swizzled by the row) ----
    hp::mbarrier_wait(staging_ready, tile_parity);
    const int r = (warp % 4) * 16 + lane / 4;  // and r + 8; r % 8 == lane / 4
    const uint32_t mine = staging + wg * kBoxes * kBoxBytes + r * 128 + quad * 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + quad * 2;
      float b[2] = {0.f, 0.f};
      if (col < N) leaf::Word<bf16>::unpack(*reinterpret_cast<const uint32_t*>(bias + col), b);
      const uint32_t at = mine + j / 8 * kBoxBytes + ((j % 8) ^ (lane / 4)) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v[2] = {acc[j * 4 + h * 2] + b[0], acc[j * 4 + h * 2 + 1] + b[1]};
        uint32_t word = leaf::Word<bf16>::pack(v);
        if (has_residual) {
          float p[2], x[2];
          leaf::Word<bf16>::unpack(word, p);
          leaf::Word<bf16>::unpack(hp::load_shared(at + h * 8 * 128), x);
          const float sum[2] = {x[0] + p[0], x[1] + p[1]};
          word = leaf::Word<bf16>::pack(sum);
        }
        hp::store_shared(at + h * 8 * 128, word);
      }
    }
    hp::fence_async_shared();
    __syncwarp();
    if (lane == 0) hp::mbarrier_arrive(staging_written);
  }
}

// cuTensorMapEncodeTiled, from the libcuda that the runtime has already loaded
// (this library does not link it).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A TMA map of a row-major bf16 matrix [rows, cols], read in boxes of
// [box_rows, 64 cols] with the 128-byte swizzle.
cudaError_t make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count(int device) {
  static int count[64] = {};
  if (device < 0 || device >= 64) return 1;
  if (count[device] == 0)
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  return count[device] > 0 ? count[device] : 1;
}

// The tile width whose tiles fill the SMs best: whole waves of 128 x BN tiles
// times the width.  Measured, a column costs the same in a 256- and a 192-wide
// tile and about 3% more in a 128-wide one (it reads A more often); a tie goes
// to the wider tile.
int pick_tile_n(int M, int N, int sms) {
  const int widths[3] = {256, 192, 128};
  const double cost_per_column[3] = {1.0, 1.0, 1.03};
  const long long tiles_m = (M + kBM - 1) / kBM;
  int best = 256;
  double best_cost = 0;
  for (int i = 0; i < 3; ++i) {
    const long long tiles = tiles_m * ((N + widths[i] - 1) / widths[i]);
    const double cost = (double)((tiles + sms - 1) / sms) * widths[i] * cost_per_column[i];
    if (i == 0 || cost < best_cost) {
      best = widths[i];
      best_cost = cost;
    }
  }
  return best;
}

template <int BN>
cudaError_t launch_gemm_bf16(const CUtensorMap* maps, const bf16* bias, bool has_residual,
                             int M, int N, int K, int sms, cudaStream_t s) {
  static bool sized = false;  // once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bias_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GemmTile<BN>::kSmemBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_bias_wgmma_kernel<BN><<<grid, kGemmThreads, GemmTile<BN>::kSmemBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], bias, has_residual, M, N, K);
  return cudaGetLastError();
}

cudaError_t gemm_bias_bf16(const bf16* a, const bf16* w, const bf16* bias,
                           const bf16* residual, bf16* out, int M, int N, int K, int tile_n,
                           int device, cudaStream_t s) {
  if (N % 8 != 0 || K % 8 != 0) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(bias) |
                         reinterpret_cast<uintptr_t>(residual) |
                         reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16 != 0) return cudaErrorMisalignedAddress;
  const int sms = sm_count(device);
  if (tile_n == 0) tile_n = pick_tile_n(M, N, sms);
  // A, W, residual, out.  The activations move with every call, so the maps
  // are encoded per launch (about a microsecond each on the host); without a
  // residual its map is the output's and is not used.
  CUtensorMap maps[4];
  cudaError_t err = make_map(&maps[0], a, M, K, kBM);
  if (err == cudaSuccess) err = make_map(&maps[1], w, K, N, kBK);
  if (err == cudaSuccess) err = make_map(&maps[2], residual != nullptr ? residual : out, M, N, 64);
  if (err == cudaSuccess) err = make_map(&maps[3], out, M, N, 64);
  if (err != cudaSuccess) return err;
  const bool res = residual != nullptr;
  switch (tile_n) {
    case 256:
      return launch_gemm_bf16<256>(maps, bias, res, M, N, K, sms, s);
    case 192:
      return launch_gemm_bf16<192>(maps, bias, res, M, N, K, sms, s);
    case 128:
      return launch_gemm_bf16<128>(maps, bias, res, M, N, K, sms, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// fp32 GEMM + bias (+ residual): 3xTF32 on wgmma, out^T = W^T A^T
// ---------------------------------------------------------------------------

constexpr int kGM = 128;        // rows of out (m) a block: the wgmma's N
constexpr int kGN = 128;        // columns of out (n) a block: 2 warpgroups of 64 (its M)
constexpr int kGK = 32;         // k a stage: one 128-byte swizzled row of fp32
constexpr int kGStages = 4;
constexpr int kGThreads = 256;  // a third warpgroup (192 columns) spilled and was slower
constexpr int kGWStride = kGN + 8;              // W rows [k][n]: 136 = 8 (mod 32) floats
constexpr int kGABytes = kGM * kGK * 4;         // A [m][k], 128-byte swizzle: 16 KB
constexpr int kGWBytes = kGK * kGWStride * 4;   // 17 x 1024
constexpr int kGStageBytes = kGABytes + kGWBytes;  // keeps every stage's A 1024-aligned
// the stages, A's lo tiles of two stages, the alignment
constexpr int kGSmemBytes = kGStages * kGStageBytes + 2 * kGABytes + 1024;

// the (A, W) tiles of k-step k0 -> shared memory, in 16-byte pieces; pieces
// past M, N or K are zeros (N and K are multiples of 4)
__device__ __forceinline__ void load_stage_wg(uint8_t* st, const float* __restrict__ A,
                                              const float* __restrict__ W, int M, int N,
                                              int K, int m0, int n0, int k0) {
  for (int i = threadIdx.x; i < kGM * kGK / 4; i += kGThreads) {
    const int r = i / 8, c = i % 8;  // 16-byte piece c of row r, swizzled by the row
    const bool valid = m0 + r < M && k0 + 4 * c < K;
    leaf::cp_async16(st + r * 128 + ((c ^ (r & 7)) * 16),
                     valid ? A + (size_t)(m0 + r) * K + k0 + 4 * c : A, valid);
  }
  float* Ws = reinterpret_cast<float*>(st + kGABytes);
  for (int i = threadIdx.x; i < kGK * kGN / 4; i += kGThreads) {
    const int r = i / (kGN / 4), c = i % (kGN / 4) * 4;
    const bool valid = k0 + r < K && n0 + c < N;
    leaf::cp_async16(Ws + r * kGWStride + c, valid ? W + (size_t)(k0 + r) * N + n0 + c : W,
                     valid);
  }
}

// A's tile of one stage -> its hi halves (in place) and lo halves, elementwise:
// the swizzle does not matter; then made visible to the products, which read
// shared memory through the async proxy
__device__ __forceinline__ void split_stage_wg(uint8_t* st, uint8_t* lo_tile) {
  float4* hi4 = reinterpret_cast<float4*>(st);
  float4* lo4 = reinterpret_cast<float4*>(lo_tile);
  for (int i = threadIdx.x; i < kGM * kGK / 4; i += kGThreads) {
    const float4 x = hi4[i];
    uint32_t h[4], l[4];
    leaf::split_tf32(x.x, h[0], l[0]);
    leaf::split_tf32(x.y, h[1], l[1]);
    leaf::split_tf32(x.z, h[2], l[2]);
    leaf::split_tf32(x.w, h[3], l[3]);
    hi4[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                         __uint_as_float(h[3]));
    lo4[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                         __uint_as_float(l[3]));
  }
  hp::fence_async_shared();
}

__global__ void __launch_bounds__(kGThreads, 1)
gemm_bias_tf32_wgmma_kernel(const float* __restrict__ A, const float* __restrict__ W,
                            const float* __restrict__ bias,
                            const float* __restrict__ residual, float* __restrict__ out,
                            int M, int N, int K) {
  extern __shared__ uint8_t gsmem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(gsmem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* lo_tiles = base + kGStages * kGStageBytes;  // A's lo halves, two stages'
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int nw = wg * 64 + (warp % 4) * 16;  // this warp's 16 rows of out^T (columns n)
  const int k_steps = (K + kGK - 1) / kGK;

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < k_steps)
      load_stage_wg(base + st * kGStageBytes, A, W, M, N, K, m0, n0, st * kGK);
    leaf::cp_async_commit();
  }
  leaf::cp_async_wait<kGStages - 2>();
  __syncthreads();
  split_stage_wg(base, lo_tiles);
  __syncthreads();
  for (int ks = 0; ks < k_steps; ++ks) {
    uint8_t* st = base + ks % kGStages * kGStageBytes;
    const float* Ws = reinterpret_cast<const float*>(st + kGABytes);
    const uint32_t a_hi = hp::smem_address(st);
    const uint32_t a_lo = hp::smem_address(lo_tiles + ks % 2 * kGABytes);
    // stage ks's products, into a fresh accumulator
#pragma unroll
    for (int kk = 0; kk < kGK / 8; ++kk) {
      // W^T's fragment: rows n, columns k: a0 = W[k t][n g], a1 = W[k t][n g + 8], ...
      const float* w = Ws + (kk * 8 + t) * kGWStride + nw + g;
      uint32_t wh[4], wl[4];
      leaf::split_tf32(w[0], wh[0], wl[0]);
      leaf::split_tf32(w[8], wh[1], wl[1]);
      leaf::split_tf32(w[4 * kGWStride], wh[2], wl[2]);
      leaf::split_tf32(w[4 * kGWStride + 8], wh[3], wl[3]);
      const uint64_t bh = hp::matrix_descriptor(a_hi + kk * 32, 16, 1024);
      const uint64_t bl = hp::matrix_descriptor(a_lo + kk * 32, 16, 1024);
      hp::wgmma_fence();
      hp::wgmma_tf32_m64n128(part, wl, bh, kk != 0);
      hp::wgmma_tf32_m64n128(part, wh, bl, 1);
      hp::wgmma_tf32_m64n128(part, wh, bh, 1);
    }
    hp::wgmma_commit();
    // while they run: the copy of stage ks + 3 into the slot of stage ks - 1
    // (its products have retired), and the split of stage ks + 1
    const int next = ks + kGStages - 1;
    if (next < k_steps)
      load_stage_wg(base + next % kGStages * kGStageBytes, A, W, M, N, K, m0, n0, next * kGK);
    leaf::cp_async_commit();
    if (ks + 1 < k_steps) {
      leaf::cp_async_wait<kGStages - 2>();
      __syncthreads();
      split_stage_wg(base + (ks + 1) % kGStages * kGStageBytes,
                     lo_tiles + (ks + 1) % 2 * kGABytes);
    }
    hp::wgmma_wait<0>();
    hp::fence_registers(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    __syncthreads();  // stage ks + 1 is split for every warpgroup
  }
  leaf::cp_async_wait<0>();

  // acc[4j + 2h + e] is out^T[nw + g + 8h][8j + 2t + e]: out[m][n] with the
  // bias of n added in fp32, then the residual
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + nw + g + 8 * h;
    if (n >= N) continue;
    const float b = bias[n];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= M) continue;
        float v = acc[4 * j + 2 * h + e] + b;
        if (residual != nullptr) v = residual[(size_t)m * N + n] + v;
        out[(size_t)m * N + n] = v;
      }
  }
}

cudaError_t gemm_bias_f32(const float* a, const float* w, const float* bias,
                          const float* residual, float* out, int M, int N, int K,
                          cudaStream_t s) {
  if (N % 4 != 0 || K % 4 != 0) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(bias) |
                         reinterpret_cast<uintptr_t>(residual) |
                         reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16 != 0) return cudaErrorMisalignedAddress;
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bias_tf32_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmemBytes);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  gemm_bias_tf32_wgmma_kernel<<<grid, kGThreads, kGSmemBytes, s>>>(a, w, bias, residual, out,
                                                                   M, N, K);
  return cudaGetLastError();
}

}  // namespace

// out[M, N] = (residual +) A[M, K] @ W[K, N] + bias[N]; residual may be null.
// bf16 only: `tile_n` is the tile width (256, 192 or 128), 0 to have it picked
// from (M, N); float32 ignores it.
extern "C" int leaf_gemm_bias_tile(const void* a, const void* w, const void* bias,
                                   const void* residual, void* out, int dtype, int M, int N,
                                   int K, int tile_n, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case leaf::kFloat32:
      return gemm_bias_f32(static_cast<const float*>(a), static_cast<const float*>(w),
                           static_cast<const float*>(bias),
                           static_cast<const float*>(residual), static_cast<float*>(out), M,
                           N, K, s);
    case leaf::kBFloat16:
      return gemm_bias_bf16(static_cast<const bf16*>(a), static_cast<const bf16*>(w),
                            static_cast<const bf16*>(bias),
                            static_cast<const bf16*>(residual), static_cast<bf16*>(out), M, N,
                            K, tile_n, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int leaf_gemm_bias(const void* a, const void* w, const void* bias,
                              const void* residual, void* out, int dtype, int M, int N,
                              int K, int device, void* stream) {
  return leaf_gemm_bias_tile(a, w, bias, residual, out, dtype, M, N, K, 0, device, stream);
}

// The whole block on x [R, L, D]: out = x + out_proj(attention(qkv_proj(LN(x)))).
// h [R, L, D], qkv [R, L, 3D] and attn [R, L, D] are scratch of x's dtype that the
// caller allocates; the four kernels run in order on `stream`.
extern "C" int leaf_fused_block(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* qkv_w, const void* qkv_b, const void* out_w,
                                const void* out_b, void* h, void* qkv, void* attn, void* out,
                                int dtype, int R, int L, int D, int n_heads, int group_len,
                                int causal, float ln_eps, float scale, int device,
                                void* stream) {
  if (R <= 0 || L <= 0 || D <= 0 || n_heads <= 0 || D % n_heads != 0)
    return cudaErrorInvalidValue;
  const long long tokens = (long long)R * L;
  if (tokens > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int M = (int)tokens;
  int err = leaf_layer_norm(x, ln_scale, ln_bias, h, dtype, M, D, ln_eps, device, stream);
  if (err != cudaSuccess) return err;
  err = leaf_gemm_bias(h, qkv_w, qkv_b, nullptr, qkv, dtype, M, 3 * D, D, device, stream);
  if (err != cudaSuccess) return err;
  err = leaf_packed_attention(qkv, attn, nullptr, dtype, R, L, n_heads, D / n_heads,
                              group_len, causal, scale, device, stream);
  if (err != cudaSuccess) return err;
  return leaf_gemm_bias(attn, out_w, out_b, x, out, dtype, M, D, D, device, stream);
}
