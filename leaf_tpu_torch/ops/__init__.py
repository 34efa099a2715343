"""Hand-written CUDA kernels of the port and their plain PyTorch
versions.  `build` compiles `csrc/*.cu` with nvcc at first use; nothing
is built or loaded at import.  Importing the package registers the
`torch.ops.leaf_tpu_torch.*` custom ops (`ops.packed_attention`), which a
model exported by `models.export` needs to load."""
from leaf_tpu_torch.ops import packed_attention  # noqa: F401
