"""Multiple ranks on `torch.distributed` (port of `leaf_tpu/parallel/`):
data parallelism only, one process per card.  The JAX package's mesh and
sharding helpers have no counterpart here; `distributed` keeps its
`local_batch_slice`."""
from leaf_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed_device, is_master, local_batch_slice, rank, world_size)
