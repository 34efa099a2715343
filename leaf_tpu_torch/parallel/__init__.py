"""Multiple ranks on `torch.distributed` (port of `leaf_tpu/parallel/`):
`distributed` (one process per card, data parallelism, with `mesh.py`'s
`local_batch_slice`) and `sharding` (a (data, model) grid of ranks and the
tensor-parallel text tower, with `mesh.py`'s `create_mesh` as
`create_grid`)."""
from leaf_tpu_torch.parallel.distributed import (  # noqa: F401
    init_distributed_device, is_master, local_batch_slice, rank, world_size)
