"""ModifiedResNet vision tower, OpenAI's RN50-family CLIP towers (port of
`leaf_tpu/models/resnet.py`).

A three-conv stem with an average pool, four stages of anti-aliased
bottlenecks (a stride-2 block average-pools before its strided 1x1
convolutions, on the main branch and the shortcut), and the attention
pool: the mean token prepended to the grid, positions added, one query
from the first token over all tokens, fp32 logits and softmax, the output
projection.

Activations are NHWC and stay NHWC-contiguous: each convolution runs on
the NCHW view `x.permute(0, 3, 1, 2)`, which is a channels-last tensor
that cuDNN takes without a copy, and its output permuted back is NHWC
again.  Kernels are OIHW (the JAX package's HWIO leaves are transposed
once, in `interop.params_from_jax`).  The convolutions are `F.conv2d` and
the attention pool plain PyTorch, as the JAX package runs them outside any
Pallas kernel: the tower launches none of the port's kernels.

BatchNorm runs in inference form from the running statistics, in fp32
with the result cast back to the activations' dtype, as the JAX package's
`batch_norm` does; its scale, bias and statistics stay fp32 whatever the
working dtype.  The contrastive and LEAF trainers take the tower (the LEAF
trainer locks it and its evals take the input's gradient through it); its
statistics are buffers that no step changes (`BatchNorm`).  `encode_image`
refuses `remat` and patch dropout, which no JAX trainer passes to it
(`layers.refuse_training`).

`resnet_openclip_to_params` is the JAX package's numpy ingestion of an
OpenCLIP `visual.*` ModifiedResNet state dict, copied: it returns that
package's pytree (HWIO kernels).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.models import layers
from leaf_tpu_torch.models.config import ResNetVisionSpec

Params = Dict[str, Any]
EXPANSION = 4


class BatchNorm(nn.Module):
    """Inference BatchNorm over the channels of NHWC x: fp32 statistics,
    scale and bias, the result in x's dtype (the JAX package's
    `batch_norm` with `train_mode=False`), in `train()` as in `eval()`.

    `scale` and `bias` train; `mean` and `var` are buffers that no step
    changes, which is what `--lock-image-freeze-bn-stats` promises and
    what the JAX contrastive driver says of its own towers ("they never
    update", `leaf_tpu/train/contrastive_driver.py:193-198, 289-292`).
    The JAX package does otherwise: its `mean` and `var` are leaves of
    the params tree (`leaf_tpu/models/resnet.py:60-79`) that `jax.grad`
    differentiates and `weight_decay_mask` marks as decayed, so AdamW
    moves them every step.  The port keeps the stated intent
    (`tests/test_torch_zoo_contrastive.py` holds both behaviours)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ((x.float() - self.mean) * torch.rsqrt(self.var + self.eps)
             * self.scale + self.bias)
        return y.to(x.dtype)


def _uniform_conv(t: torch.Tensor, generator: torch.Generator) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for an OIHW kernel (the JAX
    package's `_init_conv`)."""
    bound = (1.0 / (t.shape[1] * t.shape[2] * t.shape[3])) ** 0.5
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class _Downsample(nn.Module):
    """The shortcut's 1x1 convolution and its BatchNorm."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.bn = BatchNorm(cout)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> (2x2 average pool) -> 1x1, each with BN, ReLU after
    the first two and after the residual sum; the shortcut pools and
    projects where the block changes the stride or the width."""

    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        self.stride = stride
        out = planes * EXPANSION
        self.conv1 = nn.Parameter(torch.zeros(planes, inplanes, 1, 1))
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Parameter(torch.zeros(planes, planes, 3, 3))
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Parameter(torch.zeros(out, planes, 1, 1))
        self.bn3 = BatchNorm(out)
        self.downsample = (_Downsample(inplanes, out)
                           if stride > 1 or inplanes != out else None)

    def init_weights(self, generator: torch.Generator) -> None:
        for w in (self.conv1, self.conv2, self.conv3):
            _uniform_conv(w, generator)
        if self.downsample is not None:
            _uniform_conv(self.downsample.conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(layers.conv_nhwc(x, self.conv1)))
        out = torch.relu(self.bn2(layers.conv_nhwc(out, self.conv2,
                                                   padding=1)))
        if self.stride > 1:
            out = layers.avg_pool_nhwc(out, self.stride)
        out = self.bn3(layers.conv_nhwc(out, self.conv3))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = layers.avg_pool_nhwc(identity, self.stride)
            identity = self.downsample.bn(
                layers.conv_nhwc(identity, self.downsample.conv))
        return torch.relu(out + identity)


def attention_pool_2d(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, output_dim] (OpenCLIP's `AttentionPool2d`): the
    mean token first, positions, q from that token alone, fp32 logits and
    softmax, `c_proj`.  Linear weights are [out, in], as the JAX package
    keeps them."""
    B, H, W, C = x.shape
    dt = x.dtype
    tokens = x.reshape(B, H * W, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p["positional_embedding"].to(dt)
    q = tokens[:, :1] @ p["q_w"].to(dt).T + p["q_b"].to(dt)
    k = tokens @ p["k_w"].to(dt).T + p["k_b"].to(dt)
    v = tokens @ p["v_w"].to(dt).T + p["v_b"].to(dt)
    hd = C // n_heads

    def heads(t):
        return t.reshape(B, t.shape[1], n_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) \
        * (hd ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    out = out.transpose(1, 2).reshape(B, C)
    return out @ p["c_w"].to(dt).T + p["c_b"].to(dt)


class ModifiedResNet(nn.Module):
    """The ModifiedResNet tower (the JAX package's `encode_image_resnet`,
    inference form)."""

    def __init__(self, spec: ResNetVisionSpec):
        super().__init__()
        self.spec = spec
        w = spec.width
        self.conv1 = nn.Parameter(torch.zeros(w // 2, 3, 3, 3))
        self.bn1 = BatchNorm(w // 2)
        self.conv2 = nn.Parameter(torch.zeros(w // 2, w // 2, 3, 3))
        self.bn2 = BatchNorm(w // 2)
        self.conv3 = nn.Parameter(torch.zeros(w, w // 2, 3, 3))
        self.bn3 = BatchNorm(w)
        inplanes = w
        for li, (blocks, planes) in enumerate(zip(
                spec.layers, (w, w * 2, w * 4, w * 8))):
            stage = []
            for b in range(blocks):
                stride = 2 if (b == 0 and li > 0) else 1
                stage.append(Bottleneck(inplanes, planes, stride))
                inplanes = planes * EXPANSION
            setattr(self, f"layer{li + 1}", nn.ModuleList(stage))
        D = w * 32
        grid = spec.image_size // 32
        self.attnpool = nn.ParameterDict({
            "positional_embedding": nn.Parameter(torch.zeros(grid * grid + 1,
                                                             D)),
            **{f"{n}_w": nn.Parameter(torch.zeros(D, D)) for n in "qkv"},
            **{f"{n}_b": nn.Parameter(torch.zeros(D)) for n in "qkv"},
            "c_w": nn.Parameter(torch.zeros(spec.output_dim, D)),
            "c_b": nn.Parameter(torch.zeros(spec.output_dim))})
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.conv1.dtype

    def stages(self):
        return [getattr(self, f"layer{i}") for i in range(1, 5)]

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_resnet` distributions: uniform fan-in
        kernels, identity BatchNorms, normal attention-pool weights of std
        D^-1/2, zero biases."""
        for w in (self.conv1, self.conv2, self.conv3):
            _uniform_conv(w, generator)
        for stage in self.stages():
            for block in stage:
                block.init_weights(generator)
        std = self.attnpool["q_w"].shape[0] ** -0.5
        for name in ("positional_embedding", "q_w", "k_w", "v_w", "c_w"):
            layers.normal_(self.attnpool[name], std, generator)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        layers.refuse_training("ModifiedResNet", remat, dropout)
        x = images.to(self.dtype)
        x = torch.relu(self.bn1(layers.conv_nhwc(x, self.conv1, stride=2,
                                                 padding=1)))
        x = torch.relu(self.bn2(layers.conv_nhwc(x, self.conv2, padding=1)))
        x = torch.relu(self.bn3(layers.conv_nhwc(x, self.conv3, padding=1)))
        x = layers.avg_pool_nhwc(x, 2)
        for stage in self.stages():
            for block in stage:
                x = block(x)
        pooled = attention_pool_2d(self.attnpool, x, self.spec.heads)
        from leaf_tpu_torch.models.clip import l2_normalize
        return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# Checkpoint ingestion (the JAX package's numpy code, copied; it returns
# that package's pytree, HWIO kernels)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def _hwio(w) -> np.ndarray:
    """torch conv weight [cout, cin, kh, kw] -> HWIO."""
    return _np(w).transpose(2, 3, 1, 0)


def resnet_openclip_to_params(sd: Mapping[str, Any],
                              prefix: str = "visual.") -> Params:
    """OpenCLIP's ModifiedResNet `visual.*` state dict -> the JAX
    package's pytree of the tower."""
    def get(k):
        return _np(sd[prefix + k])

    def bn(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias"),
                "mean": get(f"{name}.running_mean"),
                "var": get(f"{name}.running_var")}

    p: Params = {}
    for i in (1, 2, 3):
        p[f"conv{i}"] = _hwio(sd[f"{prefix}conv{i}.weight"])
        p[f"bn{i}"] = bn(f"bn{i}")
    for li in range(1, 5):
        blocks = []
        b = 0
        while f"{prefix}layer{li}.{b}.conv1.weight" in sd:
            base = f"layer{li}.{b}."
            bp = {}
            for i in (1, 2, 3):
                bp[f"conv{i}"] = _hwio(sd[f"{prefix}{base}conv{i}.weight"])
                bp[f"bn{i}"] = bn(f"{base}bn{i}")
            if f"{prefix}{base}downsample.0.weight" in sd:
                bp["downsample"] = {
                    "conv": _hwio(sd[f"{prefix}{base}downsample.0.weight"]),
                    "bn": bn(base + "downsample.1")}
            blocks.append(bp)
            b += 1
        p[f"layer{li}"] = blocks
    ap = "attnpool."
    p["attnpool"] = {"positional_embedding": get(ap + "positional_embedding")}
    for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                      ("c_proj", "c")):
        p["attnpool"][f"{key}_w"] = get(f"{ap}{name}.weight")
        p["attnpool"][f"{key}_b"] = get(f"{ap}{name}.bias")
    return p


def params_to_openclip_resnet(sd: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """The port's `visual.*` ModifiedResNet entries -> OpenCLIP's keys
    (fp32 CPU tensors; kernels are OIHW in both): the inverse of
    `resnet_openclip_to_params` through `params_from_jax`."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, value: torch.Tensor) -> None:
        out["visual." + key] = value.detach().to("cpu", torch.float32) \
            .contiguous()

    def bn(src: str, dst: str) -> None:
        for s, d in (("scale", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
            put(f"{dst}.{d}", sd[f"visual.{src}.{s}"])

    for i in (1, 2, 3):
        put(f"conv{i}.weight", sd[f"visual.conv{i}"])
        bn(f"bn{i}", f"bn{i}")
    for li in range(1, 5):
        b = 0
        while f"visual.layer{li}.{b}.conv1" in sd:
            base = f"layer{li}.{b}."
            for i in (1, 2, 3):
                put(f"{base}conv{i}.weight", sd[f"visual.{base}conv{i}"])
                bn(f"{base}bn{i}", f"{base}bn{i}")
            if f"visual.{base}downsample.conv" in sd:
                put(f"{base}downsample.0.weight",
                    sd[f"visual.{base}downsample.conv"])
                bn(f"{base}downsample.bn", f"{base}downsample.1")
            b += 1
    put("attnpool.positional_embedding",
        sd["visual.attnpool.positional_embedding"])
    for name, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                      ("c_proj", "c")):
        put(f"attnpool.{name}.weight", sd[f"visual.attnpool.{key}_w"])
        put(f"attnpool.{name}.bias", sd[f"visual.attnpool.{key}_b"])
    return out
