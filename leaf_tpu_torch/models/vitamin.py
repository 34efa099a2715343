"""ViTamin vision towers (port of `leaf_tpu/models/vitamin.py`).

The timm `vitamin_{small,base,large,large2,xlarge}_<size>` trunks behind
OpenCLIP's `model_configs/ViTamin-*.json` (`timm_pool: ""`, `timm_proj:
"linear"`: the trunk's features at the ViT width, then OpenCLIP's linear
head without a bias).  A three-stage hybrid at strides 2/4/8/16:

  * the stem: 3x3 conv stride 2 -> LayerNorm -> GELU -> 3x3 conv;
  * two stages of MBConv-LN blocks: LayerNorm, 1x1 expand x4, GELU, 3x3
    depthwise (stride 2 in a stage's first block), GELU, 1x1 project, plus
    the shortcut: identity, a 1x1 conv, or timm's `Downsample2d` (a 2x2
    average pool, then the 1x1 conv only where the width changes: there
    is none where cin == cout, and a checkpoint carries no weights there);
  * the embedding: LayerNorm -> 3x3 conv stride 2 to the ViT width;
  * pre-LN ViT blocks over the 16x16-stride tokens (no class token, no
    positions): a fused-qkv attention, and a GeGLU MLP with its own input
    LayerNorm (gelu(w0 x) * (w1 x) -> w2, hidden 2 x width);
  * the mean of the tokens, then `fc_norm`, then the projection.

The attention is the unpacked branch of `layers.attention`, plain PyTorch
with fp32 logits, as the JAX package's `_vit_block` calls
`layers.attention` without `packed` and so takes its XLA branch: no packed
kernel runs.  Every LayerNorm is the LayerNorm op on contiguous NHWC or
token rows: at ViTamin-L the stem's 1, the MBConv blocks' 6, the
embedding's 1, 3 in each of 31 ViT blocks and `fc_norm`, 102 launches an
encode.  Convolutions run on channels-last views of the NHWC activations
(`layers.conv_nhwc`), with OIHW kernels.

`timm_vitamin_to_params` is the JAX package's numpy ingestion, copied:
timm's `patch_embed.backbone.{stem, stages.S.blocks.B, pool}` (the hybrid
embedding around the MBConv stages), `blocks.N` with `mlp.{norm, w0, w1,
w2}`, `fc_norm`, and OpenCLIP's `visual.head.proj`.  It returns that
package's pytree (HWIO kernels, the ViT blocks stacked).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.models import layers

Params = Dict[str, Any]
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTaminVisionSpec:
    name: str
    image_size: int = 224
    dims: Tuple[int, int, int] = (160, 320, 1024)   # the stages' widths
    depths: Tuple[int, int] = (2, 4)                # MBConv blocks a stage
    vit_depth: int = 31
    heads: int = 16
    output_dim: int = 768
    expand_ratio: int = 4

    @property
    def grid_size(self) -> int:
        return self.image_size // 16                # stride-16 tokens

    @property
    def width(self) -> int:                         # the ViT stage's width
        return self.dims[2]

    # what the placeholder VisionConfig of a trunk config reads
    @property
    def patch_size(self) -> int:
        return 16

    @property
    def layers(self) -> int:
        return self.vit_depth


_DIMS = {
    "small": ((64, 128, 384), 14, 6),
    "base": ((128, 256, 768), 14, 12),
    "large": ((160, 320, 1024), 31, 16),
    "large2": ((160, 320, 1024), 31, 16),   # L2: the L trunk, 1024-d head
    "xlarge": ((192, 384, 1152), 32, 16),
}

_NAME_RE = re.compile(r"^vitamin_(small|base|large2?|xlarge)_(\d+)$")


def match_vitamin(name: str, embed_dim: int,
                  image_size: Optional[int] = None, pool: str = "",
                  proj: str = "linear") -> Optional[ViTaminVisionSpec]:
    """The trunk registry's matcher: OpenCLIP timm_model_name -> spec."""
    m = _NAME_RE.match(name)
    if not m:
        if name.startswith("vitamin"):
            raise ValueError(f"unsupported ViTamin trunk {name!r}; "
                             f"implemented sizes: {sorted(_DIMS)}")
        return None
    dims, depth, heads = _DIMS[m.group(1)]
    return ViTaminVisionSpec(
        name=name, image_size=image_size or int(m.group(2)), dims=dims,
        vit_depth=depth, heads=heads, output_dim=embed_dim)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _conv(cout: int, cin: int, k: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cout, cin, k, k))


def _bias(c: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(c))


class MbConv(nn.Module):
    """An MBConv-LN block; a 1x1 shortcut conv (`sc_w`) only where the
    width changes."""

    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        mid = cout * expand
        self.stride = stride
        self.ln = layers.LayerNorm(cin, LN_EPS)
        self.exp_w, self.exp_b = _conv(mid, cin, 1), _bias(mid)
        self.dw_w, self.dw_b = _conv(mid, 1, 3), _bias(mid)
        self.proj_w, self.proj_b = _conv(cout, mid, 1), _bias(cout)
        self.sc_w = _conv(cout, cin, 1) if cin != cout else None
        self.sc_b = _bias(cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.stride == 2:
            shortcut = layers.avg_pool_nhwc(x, 2)
        if self.sc_w is not None:
            shortcut = layers.conv_nhwc(shortcut, self.sc_w, self.sc_b)
        h = layers.conv_nhwc(self.ln(x), self.exp_w, self.exp_b)
        h = layers.gelu(h)
        h = layers.conv_nhwc(h, self.dw_w, self.dw_b, stride=self.stride,
                             padding=1, groups=h.shape[-1])
        h = layers.gelu(h)
        return layers.conv_nhwc(h, self.proj_w, self.proj_b) + shortcut


class _GeGluMlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        hidden = 2 * width
        self.ln = layers.LayerNorm(width, LN_EPS)
        self.w0_w = nn.Parameter(torch.zeros(width, hidden))
        self.w0_b = _bias(hidden)
        self.w1_w = nn.Parameter(torch.zeros(width, hidden))
        self.w1_b = _bias(hidden)
        self.w2_w = nn.Parameter(torch.zeros(hidden, width))
        self.w2_b = _bias(width)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt = h.dtype
        h = self.ln(h)
        g = layers.gelu(h @ self.w0_w.to(dt) + self.w0_b.to(dt))
        u = h @ self.w1_w.to(dt) + self.w1_b.to(dt)
        return (g * u) @ self.w2_w.to(dt) + self.w2_b.to(dt)


class _VitBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = layers.LayerNorm(width, LN_EPS)
        self.attn = nn.ParameterDict({
            "qkv_w": nn.Parameter(torch.zeros(width, 3 * width)),
            "qkv_b": _bias(3 * width),
            "out_w": nn.Parameter(torch.zeros(width, width)),
            "out_b": _bias(width)})
        self.ln_2 = layers.LayerNorm(width, LN_EPS)
        self.mlp = _GeGluMlp(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = {k: v.to(x.dtype) for k, v in self.attn.items()}
        x = x + layers.attention(attn, self.ln_1(x), None, self.heads)
        return x + self.mlp(self.ln_2(x))


class ViTamin(nn.Module):
    """A ViTamin tower (the JAX package's `encode_image_vitamin`)."""

    def __init__(self, spec: ViTaminVisionSpec):
        super().__init__()
        self.spec = spec
        d0, d1, d2 = spec.dims
        self.stem = nn.Module()
        self.stem.conv1_w, self.stem.conv1_b = _conv(d0, 3, 3), _bias(d0)
        self.stem.ln = layers.LayerNorm(d0, LN_EPS)
        self.stem.conv2_w, self.stem.conv2_b = _conv(d0, d0, 3), _bias(d0)
        self.stages = nn.ModuleList(
            nn.ModuleList(MbConv(cin if b == 0 else cout, cout,
                                 2 if b == 0 else 1, spec.expand_ratio)
                          for b in range(spec.depths[si]))
            for si, (cin, cout) in enumerate([(d0, d0), (d0, d1)]))
        self.embed = nn.Module()
        self.embed.ln = layers.LayerNorm(d1, LN_EPS)
        self.embed.conv_w, self.embed.conv_b = _conv(d2, d1, 3), _bias(d2)
        self.blocks = nn.ModuleList(_VitBlock(d2, spec.heads)
                                    for _ in range(spec.vit_depth))
        self.fc_norm = layers.LayerNorm(d2, LN_EPS)
        self.proj = nn.Parameter(torch.zeros(d2, spec.output_dim))
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.stem.conv1_w.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_vitamin`: normal(0.02) weights, zero
        biases, unit LayerNorms."""
        for name, t in self.named_parameters():
            if name.endswith("_w") or name == "proj":
                layers.normal_(t, 0.02, generator)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        layers.refuse_training("ViTamin", remat, dropout)
        dt = self.dtype
        st = self.stem
        x = layers.conv_nhwc(images.to(dt), st.conv1_w, st.conv1_b, stride=2,
                             padding=1)
        x = layers.gelu(st.ln(x))
        x = layers.conv_nhwc(x, st.conv2_w, st.conv2_b, padding=1)
        for stage in self.stages:
            for block in stage:
                x = block(x)
        x = layers.conv_nhwc(self.embed.ln(x), self.embed.conv_w,
                             self.embed.conv_b, stride=2, padding=1)
        B, H, W, D = x.shape
        x = x.reshape(B, H * W, D)
        for block in self.blocks:
            x = block(x)
        pooled = self.fc_norm(x.mean(dim=1))           # global_pool 'avg'
        pooled = pooled @ self.proj.to(dt)             # OpenCLIP's head
        from leaf_tpu_torch.models.clip import l2_normalize
        return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# timm state dicts (the JAX package's numpy code, copied)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def _hwio(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)      # torch OIHW (or [C, 1, k, k]) -> HWIO


def timm_vitamin_to_params(sd: Mapping[str, Any], spec: ViTaminVisionSpec,
                           trunk_prefix: str = "visual.trunk.",
                           head_prefix: str = "visual.head.") -> Params:
    """timm ViTamin state dict -> the JAX package's pytree."""
    def g(k):
        return _np(sd[trunk_prefix + k])

    be = "patch_embed.backbone."

    def mb(si, bi):
        b = f"{be}stages.{si}.blocks.{bi}."
        p = {"ln": {"scale": g(b + "pre_norm.weight"),
                    "bias": g(b + "pre_norm.bias")},
             "exp_w": _hwio(g(b + "conv1_1x1.weight")),
             "exp_b": g(b + "conv1_1x1.bias"),
             "dw_w": _hwio(g(b + "conv2_kxk.weight")),
             "dw_b": g(b + "conv2_kxk.bias"),
             "proj_w": _hwio(g(b + "conv3_1x1.weight")),
             "proj_b": g(b + "conv3_1x1.bias")}
        for sc in ("shortcut.expand.weight", "shortcut.conv.weight",
                   "shortcut.weight"):
            if trunk_prefix + b + sc in sd:
                p["sc_w"] = _hwio(g(b + sc))
                p["sc_b"] = g(b + sc.replace("weight", "bias"))
                break
        return p

    L = spec.vit_depth

    def stack(fmt, transpose=False):
        per = [g(fmt.format(i)) for i in range(L)]
        return np.stack([w.T for w in per] if transpose else per)

    def ln(fmt):
        return {"scale": stack(fmt + ".weight"), "bias": stack(fmt + ".bias")}

    return {
        "stem": {"conv1_w": _hwio(g(be + "stem.conv1.weight")),
                 "conv1_b": g(be + "stem.conv1.bias"),
                 "ln": {"scale": g(be + "stem.norm1.weight"),
                        "bias": g(be + "stem.norm1.bias")},
                 "conv2_w": _hwio(g(be + "stem.conv2.weight")),
                 "conv2_b": g(be + "stem.conv2.bias")},
        "stages": [[mb(si, bi) for bi in range(spec.depths[si])]
                   for si in range(2)],
        "embed": {"ln": {"scale": g(be + "pool.norm.weight"),
                         "bias": g(be + "pool.norm.bias")},
                  "conv_w": _hwio(g(be + "pool.proj.weight")),
                  "conv_b": g(be + "pool.proj.bias")},
        "blocks": {
            "ln_1": ln("blocks.{}.norm1"),
            "attn": {"qkv_w": stack("blocks.{}.attn.qkv.weight", True),
                     "qkv_b": stack("blocks.{}.attn.qkv.bias"),
                     "out_w": stack("blocks.{}.attn.proj.weight", True),
                     "out_b": stack("blocks.{}.attn.proj.bias")},
            "ln_2": ln("blocks.{}.norm2"),
            "mlp": {"ln": ln("blocks.{}.mlp.norm"),
                    "w0_w": stack("blocks.{}.mlp.w0.weight", True),
                    "w0_b": stack("blocks.{}.mlp.w0.bias"),
                    "w1_w": stack("blocks.{}.mlp.w1.weight", True),
                    "w1_b": stack("blocks.{}.mlp.w1.bias"),
                    "w2_w": stack("blocks.{}.mlp.w2.weight", True),
                    "w2_b": stack("blocks.{}.mlp.w2.bias")},
        },
        "fc_norm": {"scale": g("fc_norm.weight"), "bias": g("fc_norm.bias")},
        "proj": _np(sd[head_prefix + "proj.weight"]).T,
    }


from leaf_tpu_torch.models.trunks import register_trunk  # noqa: E402

register_trunk(ViTaminVisionSpec, ViTamin, timm_vitamin_to_params,
               match_vitamin)
