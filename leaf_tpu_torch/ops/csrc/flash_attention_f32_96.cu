// The fp32 kernels of flash attention (attention_mma.cuh, the online
// softmax only) for heads of 81 to 96 columns, in a file of their own so that
// nvcc builds each head width's kernels beside the others'.
#include "attention_mma.cuh"

template cudaError_t leaf::mma::launch_f32_width<leaf::mma::FlashF32, false, 96>(
    const leaf::mma::ParamsT<float>&, const leaf::mma::Plan&, cudaStream_t);
