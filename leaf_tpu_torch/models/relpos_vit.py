"""Relative-position ViT trunk, timm `vit_relpos_medium_patch16_cls_224`
(port of `leaf_tpu/models/relpos_vit.py`).

The trunk behind OpenCLIP's
`model_configs/vit_relpos_medium_patch16_cls_224.json` (`timm_pool: ""`:
the trunk's class-token pool; `timm_proj: linear`):

  * a 16x16 patchify (a reshape and one matmul), no absolute position
    embedding, a class token in front;
  * pre-LN blocks (LayerNorm eps 1e-6) whose qkv has no bias; each
    attention owns a RelPosMlp ('cr' mode): a 2 -> 256 -> heads ReLU MLP,
    in fp32, over the signed-log relative coordinates sign(d) * log1p(|d|)
    of the (2g-1)^2 table, gathered into a [heads, N, N] bias with the
    index table Swin uses (`swin.rel_pos_index`), zero-padded over the
    class-token row and column;
  * the final LayerNorm, the class token, the linear head.

The attention is plain PyTorch with fp32 logits and softmax, as the JAX
package computes it outside any Pallas kernel; every LayerNorm is the
LayerNorm op (2 a block and `ln_post`: 25 launches an encode at the
medium trunk); the packed kernels run in the text tower alone.

`timm_relpos_to_params` is the JAX package's numpy ingestion, copied; it
returns that package's pytree (blocks stacked).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from leaf_tpu_torch.models import layers
from leaf_tpu_torch.models.swin import rel_pos_index

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class RelPosViTSpec:
    name: str
    image_size: int = 224
    patch_size: int = 16
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    rel_pos_dim: int = 256          # the RelPosMlp's hidden width
    qkv_bias: bool = False
    output_dim: int = 512
    proj_bias: bool = False         # OpenCLIP's head bias
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


RELPOS_TRUNKS = {
    "vit_relpos_medium_patch16_cls_224": dict(
        patch_size=16, width=512, layers=12, heads=8, rel_pos_dim=256,
        qkv_bias=False),
}


def match_relpos(name: str, embed_dim: int, image_size: Optional[int] = None,
                 pool: str = "", proj: str = "linear"
                 ) -> Optional[RelPosViTSpec]:
    """The trunk registry's matcher: OpenCLIP timm_model_name -> spec."""
    if name not in RELPOS_TRUNKS:
        if name.startswith("vit_relpos"):
            raise ValueError(
                f"unsupported relpos-ViT trunk {name!r}; implemented: "
                f"{sorted(RELPOS_TRUNKS)}")
        return None
    kw = dict(RELPOS_TRUNKS[name])
    if image_size:
        kw["image_size"] = image_size
    return RelPosViTSpec(name=name, output_dim=embed_dim, **kw)


def rel_log_coords(g: int) -> np.ndarray:
    """[(2g-1)^2, 2] signed-log relative (dy, dx) table (timm's
    `gen_relative_log_coords`, mode 'cr')."""
    r = np.arange(-(g - 1), g, dtype=np.float32)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    coords = np.stack([dy, dx], axis=-1).reshape(-1, 2)
    return np.sign(coords) * np.log1p(np.abs(coords))


class _RelPosMlp(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.fc1_w = nn.Parameter(torch.zeros(2, hidden))
        self.fc1_b = nn.Parameter(torch.zeros(hidden))
        self.fc2_w = nn.Parameter(torch.zeros(hidden, heads))
        self.fc2_b = nn.Parameter(torch.zeros(heads))

    def forward(self, coords: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
        """-> [heads, N+1, N+1] fp32 bias, zero over the class token's row
        and column."""
        h = F.relu(coords @ self.fc1_w.float() + self.fc1_b.float())
        table = h @ self.fc2_w.float() + self.fc2_b.float()  # [(2g-1)^2, H]
        bias = table[index].permute(2, 0, 1)                  # [H, N, N]
        return F.pad(bias, (1, 0, 1, 0))


class _Attention(nn.Module):
    def __init__(self, spec: RelPosViTSpec):
        super().__init__()
        D = spec.width
        self.heads = spec.heads
        self.qkv_w = nn.Parameter(torch.zeros(D, 3 * D))
        self.qkv_b = (nn.Parameter(torch.zeros(3 * D)) if spec.qkv_bias
                      else None)
        self.out_w = nn.Parameter(torch.zeros(D, D))
        self.out_b = nn.Parameter(torch.zeros(D))
        self.rel_pos = _RelPosMlp(spec.rel_pos_dim, spec.heads)

    def forward(self, x: torch.Tensor, coords: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        H = self.heads
        hd = D // H
        dt = x.dtype
        qkv = x @ self.qkv_w.to(dt)
        if self.qkv_b is not None:
            qkv = qkv + self.qkv_b.to(dt)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        logits = logits + self.rel_pos(coords, index)[None]
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(1, 2).reshape(B, S, D)
        return out @ self.out_w.to(dt) + self.out_b.to(dt)


class _Block(nn.Module):
    def __init__(self, spec: RelPosViTSpec):
        super().__init__()
        self.ln_1 = layers.LayerNorm(spec.width, spec.ln_eps)
        self.attn = _Attention(spec)
        self.ln_2 = layers.LayerNorm(spec.width, spec.ln_eps)
        self.mlp = layers.Mlp(spec.width, spec.mlp_hidden, layers.gelu)

    def forward(self, x: torch.Tensor, coords: torch.Tensor,
                index: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), coords, index)
        return x + self.mlp(self.ln_2(x))


class RelPosViT(nn.Module):
    """A RelPos-ViT tower (the JAX package's `encode_image_relpos`)."""

    def __init__(self, spec: RelPosViTSpec):
        super().__init__()
        self.spec = spec
        D = spec.width
        self.patch_embedding = nn.Parameter(
            torch.zeros(spec.patch_size ** 2 * 3, D))
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.blocks = nn.ModuleList(_Block(spec) for _ in range(spec.layers))
        self.ln_post = layers.LayerNorm(D, spec.ln_eps)
        self.proj = nn.Parameter(torch.zeros(D, spec.output_dim))
        self.register_parameter(
            "proj_bias", nn.Parameter(torch.zeros(spec.output_dim))
            if spec.proj_bias else None)
        g = spec.grid_size
        self.register_buffer("coords", torch.from_numpy(rel_log_coords(g)),
                             persistent=False)
        self.register_buffer("index", torch.from_numpy(
            rel_pos_index(g).astype(np.int64)), persistent=False)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.patch_embedding.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_relpos`: normal(0.02) weights, zero
        biases, unit LayerNorms."""
        for name, t in self.named_parameters():
            if name.endswith("_w") or name in ("patch_embedding",
                                               "class_embedding", "proj"):
                layers.normal_(t, 0.02, generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the head's bias is whatever the weights carry, as in JAX
        layers.adopt_optional_param(self, "proj_bias", state_dict,
                                    prefix + "proj_bias")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        from leaf_tpu_torch.models.clip import l2_normalize, patchify
        layers.refuse_training("RelPos-ViT", remat, dropout)
        dt = self.dtype
        x = patchify(images.to(dt), self.spec.patch_size) \
            @ self.patch_embedding.to(dt) + self.patch_bias.to(dt)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)          # no absolute positions
        for block in self.blocks:
            x = block(x, self.coords, self.index)
        pooled = self.ln_post(x)[:, 0]          # global_pool 'token'
        pooled = pooled @ self.proj.to(dt)
        if self.proj_bias is not None:
            pooled = pooled + self.proj_bias.to(dt)
        return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# timm state dicts (the JAX package's numpy code, copied)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def timm_relpos_to_params(sd: Mapping[str, Any], spec: RelPosViTSpec,
                          trunk_prefix: str = "visual.trunk.",
                          head_prefix: str = "visual.head.") -> Params:
    """timm VisionTransformerRelPos state dict -> the JAX package's pytree:
    `patch_embed.proj`, `cls_token`, `blocks.N.{norm1, attn.qkv,
    attn.rel_pos.mlp.fc1/fc2, attn.proj, norm2, mlp.fc1/fc2}`, `norm`;
    OpenCLIP's head `visual.head.proj`."""
    def g(k):
        return _np(sd[trunk_prefix + k])

    conv = g("patch_embed.proj.weight")
    p = conv.shape[-1]
    L = spec.layers

    def stack(fmt, transpose=False):
        per = [g(fmt.format(i)) for i in range(L)]
        return np.stack([w.T for w in per] if transpose else per)

    def ln(fmt):
        return {"scale": stack(fmt + ".weight"), "bias": stack(fmt + ".bias")}

    attn = {"qkv_w": stack("blocks.{}.attn.qkv.weight", True),
            "out_w": stack("blocks.{}.attn.proj.weight", True),
            "out_b": stack("blocks.{}.attn.proj.bias"),
            "rel_pos": {
                "fc1_w": stack("blocks.{}.attn.rel_pos.mlp.fc1.weight", True),
                "fc1_b": stack("blocks.{}.attn.rel_pos.mlp.fc1.bias"),
                "fc2_w": stack("blocks.{}.attn.rel_pos.mlp.fc2.weight", True),
                "fc2_b": stack("blocks.{}.attn.rel_pos.mlp.fc2.bias")}}
    if spec.qkv_bias:
        attn["qkv_b"] = stack("blocks.{}.attn.qkv.bias")
    out = {
        "patch_embedding": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, -1),
        "patch_bias": g("patch_embed.proj.bias"),
        "class_embedding": g("cls_token").reshape(-1),
        "blocks": {"ln_1": ln("blocks.{}.norm1"), "attn": attn,
                   "ln_2": ln("blocks.{}.norm2"),
                   "mlp": {"fc_w": stack("blocks.{}.mlp.fc1.weight", True),
                           "fc_b": stack("blocks.{}.mlp.fc1.bias"),
                           "proj_w": stack("blocks.{}.mlp.fc2.weight", True),
                           "proj_b": stack("blocks.{}.mlp.fc2.bias")}},
        "ln_post": {"scale": g("norm.weight"), "bias": g("norm.bias")},
        "proj": _np(sd[head_prefix + "proj.weight"]).T,
    }
    if head_prefix + "proj.bias" in sd:
        out["proj_bias"] = _np(sd[head_prefix + "proj.bias"])
    return out


from leaf_tpu_torch.models.trunks import register_trunk  # noqa: E402

register_trunk(RelPosViTSpec, RelPosViT, timm_relpos_to_params, match_relpos)
