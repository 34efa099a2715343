"""gemm_roofline.leaf: the fused block's hand-written qkv and out GEMMs
(`ops/csrc/fused_block.cu`, `gemm_bias_*` kernels) in the LEAF step, in
percent of their roofline: the sum over the required forward calls (two
a layer of each encode) of the larger of operations over the bf16 peak
and bytes over the memory's rate, over the device time of the kernels
named below.  Moves leaf_samples_per_s."""
from portbench.metrics import arith

KERNELS = ("gemm_bias_",)


def read(trace):
    work = arith.encodes(trace, "leaf")
    bound = sum(arith.gemm_forward_bound_s(e) for e in work)
    return arith.share_percent(bound, arith.kernel_seconds(trace.kernels,
                                                           KERNELS))
