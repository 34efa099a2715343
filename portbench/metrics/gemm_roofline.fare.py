"""gemm_roofline.fare: the fused block's hand-written qkv and out GEMMs
(`ops/csrc/fused_block.cu`, `gemm_bias_*` kernels) at ViT-H's width in
the FARE step, in percent of their roofline: the required forward calls
(anchors, every PGD iteration, the update; remat's recompute not counted)
against the device time of the kernels named below.  Moves
fare_images_per_s."""
from portbench.metrics import arith

KERNELS = ("gemm_bias_",)


def read(trace):
    work = arith.encodes(trace, "fare")
    bound = sum(arith.gemm_forward_bound_s(e) for e in work)
    return arith.share_percent(bound, arith.kernel_seconds(trace.kernels,
                                                           KERNELS))
