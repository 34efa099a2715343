"""PyTorch + CUDA port of `leaf_tpu`, for one NVIDIA Hopper GPU.

Each module mirrors its counterpart in the JAX package
(`leaf_tpu_torch/models/clip.py` <-> `leaf_tpu/models/clip.py`, ...),
which stays the reference the port is tested against.  The port never
imports `jax`.

The first slice is the serving path, `python -m leaf_tpu_torch.serve`:
BPE tokenizer and context bucketing on the host, then the CLIP text and
vision towers, whose attention sub-blocks run hand-written CUDA kernels
(`ops/csrc/`) built with nvcc at first use.

Nothing heavy is imported here; import the submodules you need.
"""
