"""Hand-written CUDA kernels of the port and their plain PyTorch
versions.  `build` compiles `csrc/*.cu` with nvcc at first use; nothing
is built or loaded at import."""
