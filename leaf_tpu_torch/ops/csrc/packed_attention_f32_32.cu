// The fp32 kernels of packed attention (attention_mma.cuh) for heads of
// 1 to 32 columns, in a file of their own so that nvcc builds each head
// width's kernels beside the others'.
#include "attention_mma.cuh"

template cudaError_t leaf::mma::launch_f32_width<leaf::mma::PackedF32, true, 32>(
    const leaf::mma::ParamsT<float>&, const leaf::mma::Plan&, cudaStream_t);
