"""optim_ms.leaf: the device's ms a traced LEAF step for the optimizer's
update (the gradients' norm, clip and AdamW): CUDA events of the program's
`train.optim.update` span (`leaf_tpu_torch.utils.tracing`), from its
first enqueued work to its last.  The interval holds the device's idle
gaps while the host launches those kernels, which `idle_dispatch_ms.leaf`
counts too: it is not the kernels' time alone.  Moves
leaf_samples_per_s."""
from portbench.metrics import spans as program


def read(trace):
    return program.optim_ms(trace, "leaf")
