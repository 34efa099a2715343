"""Weight-only int8 quantization of the transformer MLP weights (port of
`leaf_tpu/models/quantize.py`).

The two MLP matmul weights of every residual block (`fc_w`, `proj_w`:
OpenCLIP's `c_fc`/`c_proj`, the set the reference's bitsandbytes swap
replaces) are stored as int8 with max-abs symmetric per-output-column
scales.  `quantize_mlp_params` turns each `layers.Mlp`'s two weight
parameters into int8 buffers with a `<name>_scale` fp32 buffer beside
them; `Mlp.forward` dequantizes through `mlp_weight`, in the JAX
package's order: `q.to(dtype) * scale.to(dtype)`.  The product with the
dequantized weight is then `torch.matmul`, as the JAX package leaves it
to XLA outside any Pallas kernel.

Weight-only: activations stay bf16/fp32.  What it saves is memory: an
MLP weight takes one byte a value instead of two (bf16) or four (fp32).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

# MLP weight names inside a block
MLP_WEIGHTS = ("fc_w", "proj_w")


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-abs symmetric per-output-column int8 of `w` [..., in, out]:
    (int8 weights, fp32 scales [..., 1, out]).  `torch.round` rounds half
    to even, as `jnp.round` does."""
    w = w.detach().float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def mlp_weight(mlp: nn.Module, name: str, dtype) -> torch.Tensor:
    """The (dequantized) MLP weight `name` of `mlp` in `dtype`: the single
    place `layers.Mlp` reads its weights."""
    w = getattr(mlp, name)
    scale = getattr(mlp, name + "_scale", None)
    if scale is not None:
        return dequantize_weight(w, scale, dtype)
    return w.to(dtype)


def quantize_mlp_params(module: nn.Module) -> nn.Module:
    """Quantize, in place, both weights of every `layers.Mlp` under
    `module` that is not quantized yet; other weights are untouched.
    Returns `module`."""
    from leaf_tpu_torch.models.layers import Mlp
    for mlp in module.modules():
        if not isinstance(mlp, Mlp):
            continue
        for name in MLP_WEIGHTS:
            if hasattr(mlp, name + "_scale"):
                continue
            q, scale = quantize_weight(getattr(mlp, name))
            delattr(mlp, name)
            mlp.register_buffer(name, q.to(mlp.fc_b.device))
            mlp.register_buffer(name + "_scale", scale.to(mlp.fc_b.device))
    return module


def quantized_nbytes(module: nn.Module) -> int:
    """Bytes of `module`'s parameters and buffers (the serving CLI's
    diagnostic)."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))
