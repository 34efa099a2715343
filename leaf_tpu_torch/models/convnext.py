"""ConvNeXt vision tower, the timm trunk of OpenCLIP's `convnext_*` configs
(port of `leaf_tpu/models/convnext.py`).

OpenCLIP wraps a timm `convnext_<size>` trunk with `timm_pool: ""` (the
trunk's own average pool and head norm) and `timm_proj: "linear" | "mlp"`.
Here it is: a 4x4 stride-4 stem convolution and LayerNorm; four stages of
(LayerNorm and a 2x2 stride-2 convolution to the stage's width, on every
stage but the first) and blocks of depthwise 7x7 -> LayerNorm -> fc1 ->
exact GELU -> fc2 -> layer scale `gamma` -> residual; the global average
pool, `head_norm`, and the projection head: linear (no bias), an MLP
(fc, GELU, proj with an optional bias) or none.  Inference semantics:
stochastic depth is the identity.

Activations are NHWC and stay NHWC-contiguous: each convolution runs on
the channels-last view `x.permute(0, 3, 1, 2)` (cuDNN takes it without a
copy, and its output permuted back is NHWC again), so every LayerNorm is
the LayerNorm op on a contiguous `[..., C]` tensor with no copy around
it: 1 + 3 + sum(depths) + 1 launches an encode (41 at `convnext_base`).
The fc layers are matmuls over the channel axis, as in the JAX package.
Kernels are OIHW; `interop.params_from_jax` transposes the JAX package's
HWIO leaves once.

`timm_convnext_to_params` is the JAX package's numpy ingestion, copied:
both key spellings (timm's `stem.*`/`stages.S.blocks.B.{conv_dw, norm,
mlp.fc1, mlp.fc2, gamma}`/`head.norm`, and the original
`downsample_layers.*`/`stages.S.B.{dwconv, pwconv1, pwconv2}`/`norm`), the
OpenCLIP head under `visual.head.{proj, mlp}`; it returns that package's
pytree (HWIO, blocks stacked).  `params_to_timm_convnext` writes the port's
state dict back with timm's spellings, for `convert`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.models import layers

Params = Dict[str, Any]
LN_EPS = 1e-6  # timm's and the original ConvNeXt's LayerNorm eps


@dataclasses.dataclass(frozen=True)
class ConvNeXtVisionSpec:
    """The trunk's shape (timm `convnext_<size>`) and OpenCLIP's head
    (`proj` 'linear': Linear without bias; 'mlp': Mlp(width, 2 embed,
    embed); 'none')."""
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    image_size: int = 256
    output_dim: int = 640
    proj: str = "linear"


# timm convnext_<size> trunk shapes
CONVNEXT_DIMS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}


def convnext_spec(timm_name: str, embed_dim: int, image_size: int = 256,
                  proj: str = "linear") -> ConvNeXtVisionSpec:
    """'convnext_base' -> ConvNeXtVisionSpec."""
    size = timm_name.removeprefix("convnext_")
    if size not in CONVNEXT_DIMS:
        raise ValueError(f"unsupported convnext trunk {timm_name!r}; "
                         f"known sizes: {sorted(CONVNEXT_DIMS)}")
    depths, dims = CONVNEXT_DIMS[size]
    return ConvNeXtVisionSpec(depths=depths, dims=dims, image_size=image_size,
                              output_dim=embed_dim, proj=proj)


def _trunc_normal(t: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 0.02^2) truncated at two standard deviations (timm's
    `_init_weights`, the JAX package's `init_convnext`)."""
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=generator)
        bad = t.abs() > 2.0
        while bool(bad.any()):
            t[bad] = torch.randn(int(bad.sum()), generator=generator,
                                 dtype=t.dtype)
            bad = t.abs() > 2.0
        t.mul_(0.02)


class Block(nn.Module):
    """Depthwise 7x7 (pad 3) -> LN -> fc1 -> GELU -> fc2 -> gamma ->
    residual, on NHWC x."""

    def __init__(self, dim: int):
        super().__init__()
        self.dw_w = nn.Parameter(torch.zeros(dim, 1, 7, 7))
        self.dw_b = nn.Parameter(torch.zeros(dim))
        self.ln = layers.LayerNorm(dim, LN_EPS)
        self.fc1_w = nn.Parameter(torch.zeros(dim, 4 * dim))
        self.fc1_b = nn.Parameter(torch.zeros(4 * dim))
        self.fc2_w = nn.Parameter(torch.zeros(4 * dim, dim))
        self.fc2_b = nn.Parameter(torch.zeros(dim))
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def init_weights(self, generator: torch.Generator) -> None:
        for t in (self.dw_w, self.fc1_w, self.fc2_w):
            _trunc_normal(t, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = layers.conv_nhwc(x, self.dw_w, self.dw_b, padding=3,
                             groups=x.shape[-1])
        h = self.ln(h)
        h = layers.gelu(h @ self.fc1_w.to(dt) + self.fc1_b.to(dt))
        h = h @ self.fc2_w.to(dt) + self.fc2_b.to(dt)
        return x + self.gamma.to(dt) * h


class _Downsample(nn.Module):
    """LN, then the 2x2 stride-2 convolution to the next width."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.ln = layers.LayerNorm(cin, LN_EPS)
        self.conv_w = nn.Parameter(torch.zeros(cout, cin, 2, 2))
        self.conv_b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layers.conv_nhwc(self.ln(x), self.conv_w, self.conv_b,
                                stride=2)


class _Stage(nn.Module):
    def __init__(self, cin: Optional[int], dim: int, depth: int):
        super().__init__()
        self.downsample = None if cin is None else _Downsample(cin, dim)
        self.blocks = nn.ModuleList(Block(dim) for _ in range(depth))


class ConvNeXt(nn.Module):
    """The ConvNeXt tower (the JAX package's `encode_image_convnext`)."""

    def __init__(self, spec: ConvNeXtVisionSpec):
        super().__init__()
        self.spec = spec
        d0, dl = spec.dims[0], spec.dims[-1]
        self.stem = nn.Module()
        self.stem.conv_w = nn.Parameter(torch.zeros(d0, 3, 4, 4))
        self.stem.conv_b = nn.Parameter(torch.zeros(d0))
        self.stem.ln = layers.LayerNorm(d0, LN_EPS)
        self.stages = nn.ModuleList(
            _Stage(spec.dims[si - 1] if si else None, dim, depth)
            for si, (depth, dim) in enumerate(zip(spec.depths, spec.dims)))
        self.head_norm = layers.LayerNorm(dl, LN_EPS)
        self.register_parameter("proj", None)
        self.head_mlp: Optional[nn.ParameterDict] = None
        if spec.proj == "linear":
            self.proj = nn.Parameter(torch.zeros(dl, spec.output_dim))
        elif spec.proj == "mlp":
            hid = 2 * spec.output_dim
            self.head_mlp = nn.ParameterDict({
                "fc_w": nn.Parameter(torch.zeros(dl, hid)),
                "fc_b": nn.Parameter(torch.zeros(hid)),
                "proj_w": nn.Parameter(torch.zeros(hid, spec.output_dim))})
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.stem.conv_w.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_convnext` distributions: truncated
        normal (0.02) kernels and fc weights, zero biases, layer scale
        1e-6, the linear projection normal with std width^-1/2."""
        _trunc_normal(self.stem.conv_w, generator)
        for stage in self.stages:
            if stage.downsample is not None:
                _trunc_normal(stage.downsample.conv_w, generator)
            for block in stage.blocks:
                block.init_weights(generator)
        if self.proj is not None:
            layers.normal_(self.proj, self.spec.dims[-1] ** -0.5, generator)
        if self.head_mlp is not None:
            _trunc_normal(self.head_mlp["fc_w"], generator)
            _trunc_normal(self.head_mlp["proj_w"], generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # an MLP head's fc2 may or may not carry a bias
        if self.head_mlp is not None:
            layers.adopt_optional(self.head_mlp, "proj_b", state_dict,
                            prefix + "head_mlp.proj_b")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        layers.refuse_training("ConvNeXt", remat, dropout)
        dt = self.dtype
        x = layers.conv_nhwc(images.to(dt), self.stem.conv_w,
                             self.stem.conv_b, stride=4)
        x = self.stem.ln(x)
        for stage in self.stages:
            if stage.downsample is not None:
                x = stage.downsample(x)
            for block in stage.blocks:
                x = block(x)
        x = self.head_norm(x.mean(dim=(1, 2)))           # global avg pool
        if self.proj is not None:
            x = x @ self.proj.to(dt)
        elif self.head_mlp is not None:
            m = self.head_mlp
            x = layers.gelu(x @ m["fc_w"].to(dt) + m["fc_b"].to(dt))
            x = x @ m["proj_w"].to(dt)
            if "proj_b" in m:
                x = x + m["proj_b"].to(dt)
        from leaf_tpu_torch.models.clip import l2_normalize
        return l2_normalize(x) if normalize else x


# ---------------------------------------------------------------------------
# timm state dicts (the JAX package's numpy code, copied)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def timm_convnext_to_params(sd: Mapping[str, Any], spec: ConvNeXtVisionSpec,
                            trunk_prefix: str = "visual.trunk.",
                            head_prefix: str = "visual.head.") -> Params:
    """timm or original ConvNeXt state dict -> the JAX package's pytree
    (HWIO kernels, each stage's blocks stacked on a leading axis)."""

    def g(*names) -> np.ndarray:
        for n in names:
            if trunk_prefix + n in sd:
                return _np(sd[trunk_prefix + n])
        raise KeyError(f"none of {names} under {trunk_prefix!r}")

    def conv_hwio(w: np.ndarray) -> np.ndarray:
        return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO

    p: Params = {
        "stem": {
            "conv_w": conv_hwio(g("stem.0.weight",
                                  "downsample_layers.0.0.weight")),
            "conv_b": g("stem.0.bias", "downsample_layers.0.0.bias"),
            "ln": {"scale": g("stem.1.weight", "downsample_layers.0.1.weight"),
                   "bias": g("stem.1.bias", "downsample_layers.0.1.bias")},
        },
        "stages": [],
        "head_norm": {"scale": g("head.norm.weight", "norm.weight"),
                      "bias": g("head.norm.bias", "norm.bias")},
    }
    for si, depth in enumerate(spec.depths):
        def b(i, *suffixes):
            names = []
            for s in suffixes:
                names += [f"stages.{si}.blocks.{i}.{s}",
                          f"stages.{si}.{i}.{s}"]
            return g(*names)

        def stack(*suffixes, t=False):
            ws = [b(i, *suffixes) for i in range(depth)]
            return np.stack([w.T if t else w for w in ws])

        # depthwise OIHW [C, 1, 7, 7] -> HWIO [7, 7, 1, C]
        dw = np.stack([b(i, "conv_dw.weight", "dwconv.weight")
                       .transpose(2, 3, 1, 0) for i in range(depth)])
        stage: Params = {"blocks": {
            "dw_w": dw,
            "dw_b": stack("conv_dw.bias", "dwconv.bias"),
            "ln": {"scale": stack("norm.weight"),
                   "bias": stack("norm.bias")},
            "fc1_w": stack("mlp.fc1.weight", "pwconv1.weight", t=True),
            "fc1_b": stack("mlp.fc1.bias", "pwconv1.bias"),
            "fc2_w": stack("mlp.fc2.weight", "pwconv2.weight", t=True),
            "fc2_b": stack("mlp.fc2.bias", "pwconv2.bias"),
            "gamma": stack("gamma"),
        }}
        if si > 0:
            stage["downsample"] = {
                "ln": {"scale": g(f"stages.{si}.downsample.0.weight",
                                  f"downsample_layers.{si}.0.weight"),
                       "bias": g(f"stages.{si}.downsample.0.bias",
                                 f"downsample_layers.{si}.0.bias")},
                "conv_w": conv_hwio(g(f"stages.{si}.downsample.1.weight",
                                      f"downsample_layers.{si}.1.weight")),
                "conv_b": g(f"stages.{si}.downsample.1.bias",
                            f"downsample_layers.{si}.1.bias"),
            }
        p["stages"].append(stage)

    has_linear = head_prefix + "proj.weight" in sd
    has_mlp = head_prefix + "mlp.fc1.weight" in sd
    if spec.proj == "linear":
        if not has_linear:
            raise KeyError(
                f"config expects a linear projection head but the "
                f"checkpoint has no {head_prefix}proj.weight"
                + (" (it carries an MLP head: config/checkpoint mismatch)"
                   if has_mlp else " (trunk-only checkpoint?)"))
        p["proj"] = _np(sd[head_prefix + "proj.weight"]).T
    elif spec.proj == "mlp":
        if not has_mlp:
            raise KeyError(
                f"config expects an MLP projection head but the "
                f"checkpoint has no {head_prefix}mlp.fc1.weight"
                + (" (it carries a linear head: config/checkpoint mismatch)"
                   if has_linear else " (trunk-only checkpoint?)"))
        m = {"fc_w": _np(sd[head_prefix + "mlp.fc1.weight"]).T,
             "fc_b": _np(sd[head_prefix + "mlp.fc1.bias"]),
             "proj_w": _np(sd[head_prefix + "mlp.fc2.weight"]).T}
        if head_prefix + "mlp.fc2.bias" in sd:
            m["proj_b"] = _np(sd[head_prefix + "mlp.fc2.bias"])
        p["head_mlp"] = m
    elif has_linear or has_mlp:
        raise KeyError(
            "config declares no projection head (proj='none') but the "
            "checkpoint carries one: embeddings would silently come out in "
            "trunk space")
    return p


def params_to_timm_convnext(sd: Mapping[str, torch.Tensor],
                            spec: ConvNeXtVisionSpec,
                            trunk_prefix: str = "visual.trunk.",
                            head_prefix: str = "visual.head."
                            ) -> Dict[str, torch.Tensor]:
    """The port's `visual.*` ConvNeXt entries -> timm's spellings (fp32 CPU
    tensors; kernels are OIHW in both, fc weights [out, in] in timm's)."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, src: str, transpose: bool = False) -> None:
        v = sd["visual." + src].detach().to("cpu", torch.float32)
        out[key] = (v.T if transpose else v).contiguous()

    put(trunk_prefix + "stem.0.weight", "stem.conv_w")
    put(trunk_prefix + "stem.0.bias", "stem.conv_b")
    put(trunk_prefix + "stem.1.weight", "stem.ln.scale")
    put(trunk_prefix + "stem.1.bias", "stem.ln.bias")
    for si, depth in enumerate(spec.depths):
        st, dst = f"stages.{si}.", f"{trunk_prefix}stages.{si}."
        if si > 0:
            put(dst + "downsample.0.weight", st + "downsample.ln.scale")
            put(dst + "downsample.0.bias", st + "downsample.ln.bias")
            put(dst + "downsample.1.weight", st + "downsample.conv_w")
            put(dst + "downsample.1.bias", st + "downsample.conv_b")
        for i in range(depth):
            src, pre = f"{st}blocks.{i}.", f"{dst}blocks.{i}."
            put(pre + "conv_dw.weight", src + "dw_w")
            put(pre + "conv_dw.bias", src + "dw_b")
            put(pre + "norm.weight", src + "ln.scale")
            put(pre + "norm.bias", src + "ln.bias")
            put(pre + "mlp.fc1.weight", src + "fc1_w", True)
            put(pre + "mlp.fc1.bias", src + "fc1_b")
            put(pre + "mlp.fc2.weight", src + "fc2_w", True)
            put(pre + "mlp.fc2.bias", src + "fc2_b")
            put(pre + "gamma", src + "gamma")
    put(trunk_prefix + "head.norm.weight", "head_norm.scale")
    put(trunk_prefix + "head.norm.bias", "head_norm.bias")
    if spec.proj == "linear" and "visual.proj" in sd:
        put(head_prefix + "proj.weight", "proj", True)
    elif spec.proj == "mlp" and "visual.head_mlp.fc_w" in sd:
        put(head_prefix + "mlp.fc1.weight", "head_mlp.fc_w", True)
        put(head_prefix + "mlp.fc1.bias", "head_mlp.fc_b")
        put(head_prefix + "mlp.fc2.weight", "head_mlp.proj_w", True)
        if "visual.head_mlp.proj_b" in sd:
            put(head_prefix + "mlp.fc2.bias", "head_mlp.proj_b")
    return out
