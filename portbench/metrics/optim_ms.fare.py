"""optim_ms.fare: the device's ms a traced FARE step for the optimizer's
update (AdamW): CUDA events of the program's `train.optim.update` span
(`leaf_tpu_torch.utils.tracing`), from its first enqueued work to its
last.  The interval holds the device's idle gaps while the host launches
those kernels: it is not the kernels' time alone.  Moves
fare_images_per_s."""
from portbench.metrics import spans as program


def read(trace):
    return program.optim_ms(trace, "fare")
