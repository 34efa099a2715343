"""attn_bwd_roofline.fare: the attention backward kernels
(`ops/csrc/attention_backward.cu`) in the FARE step, in percent of their
roofline: the sum over the required backward calls (one a layer of every
PGD iteration's input gradient and of the update's gradient) of the
larger of operations over the bf16 peak and bytes over the memory's rate,
over the device time of the kernels named below.  Moves
fare_images_per_s."""
from portbench.metrics import arith

KERNELS = ("attention_backward_dq_kernel", "attention_backward_dkv_kernel")


def read(trace):
    work = [e for e in arith.encodes(trace, "fare") if e.grad != "none"]
    bound = sum(arith.attention_backward_bound_s(e) for e in work)
    return arith.share_percent(bound, arith.kernel_seconds(trace.kernels,
                                                           KERNELS))
