"""attn_roofline.leaf: the packed-attention forward kernel
(`ops/csrc/packed_attention.cu`) in the LEAF step, in percent of its
roofline: the sum over the step's required attention calls (one a layer of
each scoring and training encode) of the larger of operations over the
bf16 peak and bytes over the memory's rate, over the device time of the
kernels named below (their recompute in the block's backward included).
A kernel renamed by the program leaves this metric reading nothing.
Moves leaf_samples_per_s."""
from portbench.metrics import arith

KERNELS = ("attention_kernel",)


def read(trace):
    work = arith.encodes(trace, "leaf")
    bound = sum(arith.attention_forward_bound_s(e) for e in work)
    return arith.share_percent(bound, arith.kernel_seconds(trace.kernels,
                                                           KERNELS))
