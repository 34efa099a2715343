"""Transformer building blocks (port of `leaf_tpu/models/layers.py`).

The JAX package stacks a tower's residual blocks on a leading layer axis
and runs them with `lax.scan`; here each block is an `nn.Module` and a
tower loops over them.  Parameter names and layouts follow the JAX
pytree (`ln_1.scale`, `attn.qkv_w` as `[D, 3D]` for `y = x @ w`, ...),
so converting a JAX pytree is a matter of un-stacking the layer axis
(`interop.params_from_jax`).

Numerics match the JAX package: LayerNorm in fp32 with fp32 parameters
and the result cast back, attention softmax in fp32, QuickGELU as
`x * sigmoid(1.702 x)`.  LayerNorm parameters stay fp32.  Matrix weights
are cast to the activations' dtype where a block uses them, once per
forward, as the JAX package's `.astype(x.dtype)` does: for serving the
factory stores them in the working dtype and the cast is the identity;
for training they stay fp32 master weights, the forward computes in
bf16, and the gradient flows back through the cast.

Dispatch of the packed attention sub-block is by device only: with
`packed` set, `ResidualBlock` always calls `ops.fused_attention_block`
and `attention` always calls `ops.packed_attention`, which launch their
CUDA kernels for CUDA tensors and run their plain versions for CPU
tensors.  `LayerNorm` is the `ops.packed_attention.layer_norm` op, with
the same dispatch: on a card `ln_2` of every block and the towers'
`ln_final`, `ln_pre` and `ln_post` run the fused block's LayerNorm
kernel (one read and one write of the activation, which is all that
bounds it), never the plain elementwise version.  The MLP's two GEMMs
with their bias adds and the activation stay `torch.matmul` and plain
PyTorch, as the JAX package leaves them to XLA; its weights may be int8
with per-column scales (`models.quantize`), dequantized where used.

The convolutional towers (ResNet, ConvNeXt, ViTamin) share `conv_nhwc`
and `avg_pool_nhwc`, which keep their activations NHWC as the JAX package
does; the zoo's towers share `refuse_training`, `adopt_optional` and
`adopt_optional_param`.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from leaf_tpu_torch.models.quantize import mlp_weight
from leaf_tpu_torch.ops.packed_attention import (fused_attention_block,
                                                 layer_norm, packed_attention)

Packed = Optional[Tuple[int, bool]]   # (group_len, causal)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """In-place N(0, std^2) draw from an explicit generator."""
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


class LayerNorm(nn.Module):
    """fp32 LayerNorm whose `scale`/`bias` stay fp32 whatever the model's
    working dtype."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None, stride: int = 1,
              padding: int = 0, groups: int = 1) -> torch.Tensor:
    """Convolution of NHWC `x` by an OIHW kernel, in x's dtype, for the
    convolutional towers (ResNet, ConvNeXt, ViTamin), which keep their
    activations NHWC as the JAX package does.  The NCHW view
    `x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor is a channels-last
    tensor, which cuDNN (and the CPU) convolve without a copy into a
    channels-last result: permuted back, it is a contiguous NHWC tensor, as
    the LayerNorm op requires."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype),
                 None if b is None else b.to(x.dtype), stride, padding, 1,
                 groups)
    return y.permute(0, 2, 3, 1)


def avg_pool_nhwc(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average pool with stride k over NHWC x (floor, no padding)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def refuse_training(family: str, remat: bool, dropout) -> None:
    """Raise for `remat` or patch dropout on a zoo tower (every tower but
    the CLIP ViT's): no trainer of the JAX package passes either to one.
    `clip.forward` calls `encode_image_model` without `remat`
    (`leaf_tpu/models/clip.py:471-472`), FARE's remat goes to the ViT's
    `encode_image`, and the LEAF driver's `--grad-checkpointing` to the
    text tower (`leaf_tpu/train/driver.py:193, 208`).  JAX's patch-dropout
    branch (`leaf_tpu/train/contrastive.py:37-48`) hands its key to
    `encode_image_model`, which drops it for these towers without a word
    (`clip.py:239-251`); the port raises rather than ignore a flag."""
    if remat or dropout is not None:
        raise NotImplementedError(
            f"{family} towers take neither remat nor patch dropout: no "
            "trainer passes either to them, in the JAX package as here "
            "(which drops a patch-dropout key for them unused)")


def adopt_optional(params: nn.ParameterDict, name: str, state_dict,
                   key: str) -> None:
    """Give `params[name]` the presence and shape it has in the weights
    being loaded (`key` of `state_dict`); an entry they share is kept."""
    t = state_dict.get(key)
    if t is None:
        if name in params:
            del params[name]
    elif name not in params or params[name].shape != t.shape:
        like = next(iter(params.values()))
        params[name] = nn.Parameter(torch.empty(t.shape, dtype=like.dtype,
                                                device=like.device))


def adopt_optional_param(module: nn.Module, name: str, state_dict,
                         key: str) -> None:
    """`adopt_optional` for a plain attribute parameter `module.<name>`
    (None where absent), such as a head's optional bias."""
    t, cur = state_dict.get(key), getattr(module, name)
    if t is None:
        module.register_parameter(name, None)
    elif cur is None or cur.shape != t.shape:
        like = next(module.parameters())
        module.register_parameter(name, nn.Parameter(torch.empty(
            t.shape, dtype=like.dtype, device=like.device)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)   # exact (erf) form


def attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              mask: Optional[torch.Tensor], n_heads: int,
              packed: Packed = None) -> torch.Tensor:
    """Multi-head self-attention; `p` holds `qkv_w`, `qkv_b`, `out_w`,
    `out_b`.

    x: [B, S, D]; mask: additive [S, S] or [B, S, S] (or None), applied
    in fp32.  `packed=(group_len, causal)` declares that `mask` IS the
    block-diagonal pattern `clip.packed_block_mask(group_len, S //
    group_len, causal)`: the packed path derives the mask from `packed`
    and ignores `mask` (never combine `packed` with another mask).

    The CLIP towers always pass `packed`.  The unpacked branch (an
    explicit additive mask, or none) is the plain PyTorch form of the JAX
    package's XLA attention: CoCa's text tower (causal plus a per-sample
    CLS-row pad mask) and its decoder's causal self-attention run it, as
    the JAX package runs them outside any Pallas kernel, and the tests
    hold the packed path against it."""
    qkv = x @ p["qkv_w"] + p["qkv_b"]
    if packed is not None:
        out = packed_attention(qkv, n_heads, packed[0], packed[1])
        return out @ p["out_w"] + p["out_b"]
    B, S, D = x.shape
    head_dim = D // n_heads

    def heads(t):
        return t.reshape(B, S, n_heads, head_dim).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (head_dim ** -0.5)
    if mask is not None:
        m = mask.float()
        if m.dim() == 3:          # per-sample additive mask [B, S, S]
            m = m[:, None]
        logits = logits + m
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    out = out.transpose(1, 2).reshape(B, S, D)
    return out @ p["out_w"] + p["out_b"]


class Mlp(nn.Module):
    def __init__(self, width: int, mlp_width: int, act):
        super().__init__()
        self.fc_w = nn.Parameter(torch.zeros(width, mlp_width))
        self.fc_b = nn.Parameter(torch.zeros(mlp_width))
        self.proj_w = nn.Parameter(torch.zeros(mlp_width, width))
        self.proj_b = nn.Parameter(torch.zeros(width))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(x @ mlp_weight(self, "fc_w", x.dtype)
                     + self.fc_b.to(x.dtype))
        return h @ mlp_weight(self, "proj_w", x.dtype) + self.proj_b.to(x.dtype)


class ResidualBlock(nn.Module):
    """Pre-LN residual attention block.  With `packed` it is one
    `fused_attention_block` call plus the MLP; without it (CoCa's text
    tower and decoder, and the tests' oracle) `ln_1` and the unpacked
    `attention`.  On a tensor-parallel grid (`tp` set by
    `parallel.sharding.shard_module`) it holds its shards and runs
    `sharding.block_forward`."""

    def __init__(self, width: int, heads: int, mlp_width: int, act,
                 ln_eps: float):
        super().__init__()
        self.n_heads = heads
        self.ln_eps = ln_eps
        self.ln_1 = LayerNorm(width, ln_eps)
        self.attn = nn.ParameterDict({
            "qkv_w": nn.Parameter(torch.zeros(width, 3 * width)),
            "qkv_b": nn.Parameter(torch.zeros(3 * width)),
            "out_w": nn.Parameter(torch.zeros(width, width)),
            "out_b": nn.Parameter(torch.zeros(width)),
        })
        self.ln_2 = LayerNorm(width, ln_eps)
        self.mlp = Mlp(width, mlp_width, act)
        # a `parallel.sharding.Grid` once the block holds its shards
        self.tp = None

    def init_weights(self, generator: torch.Generator, layers: int) -> None:
        """The JAX package's init (`init_block_stack`) for a tower of
        `layers` blocks: normal weights, zero biases, unit LN scales."""
        width = self.ln_1.scale.shape[0]
        proj_std = (width ** -0.5) * ((2 * layers) ** -0.5)
        normal_(self.attn["qkv_w"], width ** -0.5, generator)
        normal_(self.attn["out_w"], proj_std, generator)
        normal_(self.mlp.fc_w, (2 * width) ** -0.5, generator)
        normal_(self.mlp.proj_w, proj_std, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                packed: Packed = None) -> torch.Tensor:
        if self.tp is not None:
            from leaf_tpu_torch.parallel.sharding import block_forward
            return block_forward(self, x, packed)
        attn = {k: v.to(x.dtype) for k, v in self.attn.items()}
        if packed is not None:
            p = {"ln_1": {"scale": self.ln_1.scale, "bias": self.ln_1.bias},
                 "attn": attn}
            x = fused_attention_block(p, x, self.n_heads, packed[0],
                                      packed[1], self.ln_eps)
        else:
            x = x + attention(attn, self.ln_1(x), mask, self.n_heads)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.ModuleList):
    """A tower's residual blocks, run in order (the JAX `lax.scan` over
    the stacked layer axis; block i's parameters are `<i>.<name>`)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_width: int,
                 act, ln_eps: float):
        super().__init__(ResidualBlock(width, heads, mlp_width, act, ln_eps)
                         for _ in range(layers))

    def init_weights(self, generator: torch.Generator) -> None:
        for block in self:
            block.init_weights(generator, len(self))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                packed: Packed = None, remat: bool = False) -> torch.Tensor:
        """`remat` keeps only each block's input for the backward pass and
        recomputes the block there (`jax.checkpoint` per block in the JAX
        package)."""
        for block in self:
            if remat and torch.is_grad_enabled():
                x = checkpoint(block, x, mask, packed, use_reentrant=False)
            else:
                x = block(x, mask, packed)
        return x
