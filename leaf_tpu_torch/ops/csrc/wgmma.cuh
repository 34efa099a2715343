// PTX wrappers for Hopper's asynchronous copy and warpgroup matrix multiply
// (sm_90a): mbarrier, TMA tile loads, shared-memory matrix descriptors and
// `wgmma.mma_async` m64nNk16 for bf16 inputs with fp32 accumulators, TMA tile
// stores.
//
// Used by the bf16 GEMM of fused_block.cu.  Operands as that kernel lays
// them out in shared memory, both filled by TMA with the 128-byte swizzle:
//   A  [64 rows, 64 k]   K-major:  a row is 128 bytes, 8 rows are one 1024-byte
//                        swizzle atom, the next 8 rows follow at +1024 (SBO);
//   B  [64 k, N cols]    MN-major (W is [K, N] row-major and is not
//                        transposed): a k row of 64 columns is 128 bytes, 8 k
//                        rows are one atom, the next 8 k rows follow at +1024
//                        (SBO), the next 64 columns at +8192 (LBO), i.e. one
//                        [64 k, 64 cols] TMA box after the other.
// The instruction's last immediate (transpose B) is 1 for the MN-major B.
#pragma once

#include <stdint.h>

namespace leaf {
namespace hopper {

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
}
// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbarrier_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase differs from `parity`.  A barrier that never
// completes (a wrong byte count, a refused copy) traps instead of hanging the
// card: each failed try_wait has already slept for the hardware's time limit.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1u << 24)) __trap();
  }
}

// ---- TMA ----------------------------------------------------------------------

// One [box rows, box cols] tile of a 2-D tensor into shared memory; elements
// outside the tensor arrive as zeros and count towards the barrier's bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tensor_map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tensor_map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// One [box rows, box cols] tile from shared memory to a 2-D tensor, as part of
// the thread's current bulk group; elements outside the tensor are dropped.
__device__ __forceinline__ void tma_store_2d(const void* tensor_map, uint32_t src, int col,
                                             int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(tensor_map)),
      "r"(src), "r"(col), "r"(row)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the thread's stores have read their shared memory (it may be written
// again), or, with kWritten, until they have reached global memory.
template <bool kWritten> __device__ __forceinline__ void tma_store_wait() {
  if (kWritten)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Orders this thread's writes to shared memory before a later TMA store of them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t load_shared(uint32_t address) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(address) : "memory");
  return v;
}
__device__ __forceinline__ void store_shared(uint32_t address, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(address), "r"(v) : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t matrix_descriptor(uint32_t address, uint32_t lbo,
                                                      uint32_t sbo) {
  return static_cast<uint64_t>((address & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products that own them.
template <int kRegs> __device__ __forceinline__ void fence_registers(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A[64 x 16] @ B[16 x N]: A K-major, B MN-major, both through
// descriptors; thread t of the warpgroup holds, for column group j and half h,
// d[4j + 2h + e] = D[16 * (t / 32) + (t % 32) / 4 + 8h][8j + 2 * (t % 4) + e].
// `accumulate` 0 overwrites d.  The register lists are mechanical.
template <int N> struct Wgmma;

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma<192> {
  __device__ __forceinline__ static void mma(float (&d)[96], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95}, "
        "%96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

}  // namespace hopper
}  // namespace leaf
