"""Swin Transformer trunk, timm `swin_base_patch4_window7_224` (port of
`leaf_tpu/models/swin.py`).

The trunk behind OpenCLIP's `model_configs/swin_base_patch4_window7_224.json`
(`timm_pool: ""`: the trunk's own average pool; `timm_proj: linear`,
embed_dim 640):

  * a 4x4 patchify (a reshape and one matmul) and a LayerNorm;
  * four stages, depths 2/2/18/2 and heads 4/8/16/32 (heads of 32) for
    Swin-B, whose width doubles at each stage's entry through a patch merge
    (the 2x2 neighbours concatenated in the order [x00, x10, x01, x11],
    a LayerNorm, a bias-less reduction 4C -> 2C) for stages 1-3;
  * pre-LN blocks that alternate plain and shifted window attention
    (shift w/2: the activation rolled by -w/2 before the partition and by
    +w/2 after the reverse) with a learned relative-position bias table
    [(2w-1)^2, heads] and the standard cross-window mask, filled with the
    finite -1e9 of the JAX package;
  * the window clamped to the grid, unshifted, where the grid is no larger
    than the window (Swin-B's last stage, 7x7);
  * the final LayerNorm, the mean over the grid, the linear head.

The JAX package scans each stage's blocks with the shift chosen per block
by a traced flag; here each block is a module whose shift is fixed when
it is built.  The window attention is plain PyTorch with fp32 logits, the
bias table gathered in fp32, and an fp32 softmax, as the JAX package
computes it outside any Pallas kernel.  Every LayerNorm is the LayerNorm
op: at Swin-B the patch norm, 2 in each of 24 blocks, 3 patch-merge norms
(D 512, 1024 and 2048: the last above the op's register path) and
`ln_post`, 53 launches an encode; the packed kernels run in the text tower
alone.

`timm_swin_to_params` is the JAX package's numpy ingestion, copied: both
timm key layouts (the patch merge filed at the entry of stage s, or at
the end of stage s - 1), returning that package's pytree (each stage's
blocks stacked), which `interop.params_from_jax` carries to the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.models import layers

Params = Dict[str, Any]

_NEG = -1e9  # the finite mask fill of the JAX package


@dataclasses.dataclass(frozen=True)
class SwinVisionSpec:
    name: str
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    heads: Tuple[int, ...] = (4, 8, 16, 32)
    window: int = 7
    mlp_ratio: float = 4.0
    output_dim: int = 640
    proj_bias: bool = False
    ln_eps: float = 1e-5

    def stage_dim(self, s: int) -> int:
        return self.embed_dim * (2 ** s)

    def stage_grid(self, s: int) -> int:
        return self.image_size // self.patch_size // (2 ** s)

    def stage_window(self, s: int) -> int:
        # the window never exceeds the grid (timm clamps it, unshifted)
        return min(self.window, self.stage_grid(s))

    def stage_shift(self, s: int) -> int:
        w = self.stage_window(s)
        return 0 if w >= self.stage_grid(s) else w // 2


SWIN_TRUNKS = {
    "swin_base_patch4_window7_224": dict(
        patch_size=4, embed_dim=128, depths=(2, 2, 18, 2),
        heads=(4, 8, 16, 32), window=7),
}


def match_swin(name: str, embed_dim: int, image_size: Optional[int] = None,
               pool: str = "", proj: str = "linear"
               ) -> Optional[SwinVisionSpec]:
    """The trunk registry's matcher: OpenCLIP timm_model_name -> spec."""
    if name not in SWIN_TRUNKS:
        if name.startswith("swin"):
            raise ValueError(
                f"unsupported swin trunk {name!r}; implemented: "
                f"{sorted(SWIN_TRUNKS)}")
        return None
    kw = dict(SWIN_TRUNKS[name])
    if image_size:
        kw["image_size"] = image_size
    return SwinVisionSpec(name=name, output_dim=embed_dim, **kw)


# ---------------------------------------------------------------------------
# Window machinery
# ---------------------------------------------------------------------------

def rel_pos_index(w: int) -> np.ndarray:
    """[w^2, w^2] int32: token pair -> row of the (2w-1)^2 bias table."""
    ys, xs = np.meshgrid(np.arange(w), np.arange(w), indexing="ij")
    pos = np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1)
    d = pos[:, None, :] - pos[None, :, :] + (w - 1)
    return (d[..., 0] * (2 * w - 1) + d[..., 1]).astype(np.int32)


def _partition_np(img: np.ndarray, w: int) -> np.ndarray:
    g = img.shape[0]
    return (img.reshape(g // w, w, g // w, w)
            .transpose(0, 2, 1, 3).reshape(-1, w * w))


def shift_attn_mask(grid: int, window: int, shift: int) -> np.ndarray:
    """[nW, w^2, w^2] additive mask of shifted-window attention: tokens
    from different pre-shift regions do not attend to each other (Swin's
    `img_mask` construction)."""
    img = np.zeros((grid, grid), np.int32)
    cnt = 0
    bounds = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in bounds:
        for ws in bounds:
            img[hs, ws] = cnt
            cnt += 1
    win = _partition_np(img, window)               # [nW, w^2]
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff == 0, 0.0, _NEG).astype(np.float32)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, w^2, C], windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // w, w, W // w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, C)


def window_reverse(x: torch.Tensor, w: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    """The inverse of `window_partition`: [B * nW, w^2, C] -> [B, H, W, C]."""
    C = x.shape[-1]
    x = x.reshape(B, H // w, W // w, w, w, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def patch_merge_concat(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C] in the order [x00, x10, x01, x11]
    (the row offset fastest)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 4, 2, 5).reshape(B, H // 2, W // 2, 4 * C)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv_w = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.qkv_b = nn.Parameter(torch.zeros(3 * dim))
        self.out_w = nn.Parameter(torch.zeros(dim, dim))
        self.out_b = nn.Parameter(torch.zeros(dim))
        self.bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                   heads))

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x: windows [Bw, w^2, C]; mask: [nW, w^2, w^2] additive, or None
        for an unshifted block."""
        Bw, N, C = x.shape
        H = self.heads
        hd = C // H
        dt = x.dtype
        qkv = x @ self.qkv_w.to(dt) + self.qkv_b.to(dt)
        q, k, v = (t.reshape(Bw, N, H, hd).transpose(1, 2)
                   for t in qkv.split(C, dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        bias = self.bias_table.float()[index]              # [N, N, H]
        logits = logits + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(Bw // nW, nW, H, N, N)
                      + mask[None, :, None]).reshape(Bw, H, N, N)
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(1, 2).reshape(Bw, N, C)
        return out @ self.out_w.to(dt) + self.out_b.to(dt)


class _Block(nn.Module):
    def __init__(self, spec: SwinVisionSpec, s: int, shift: int):
        super().__init__()
        C = spec.stage_dim(s)
        self.window, self.shift = spec.stage_window(s), shift
        self.ln_1 = layers.LayerNorm(C, spec.ln_eps)
        self.attn = _WindowAttention(C, spec.heads[s], self.window)
        self.ln_2 = layers.LayerNorm(C, spec.ln_eps)
        self.mlp = layers.Mlp(C, int(C * spec.mlp_ratio), layers.gelu)

    def forward(self, h: torch.Tensor, index: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, H, W, _ = h.shape
        w, sh = self.window, self.shift
        y = self.ln_1(h)
        if sh:
            y = torch.roll(y, (-sh, -sh), dims=(1, 2))
        y = self.attn(window_partition(y, w), index, mask if sh else None)
        y = window_reverse(y, w, B, H, W)
        if sh:
            y = torch.roll(y, (sh, sh), dims=(1, 2))
        h = h + y
        return h + self.mlp(self.ln_2(h))


class _PatchMerge(nn.Module):
    def __init__(self, dim_in: int, ln_eps: float):
        super().__init__()
        self.norm = layers.LayerNorm(4 * dim_in, ln_eps)
        self.reduction = nn.Parameter(torch.zeros(4 * dim_in, 2 * dim_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(patch_merge_concat(x))
        return x @ self.reduction.to(x.dtype)


class _Stage(nn.Module):
    """An optional entry patch merge, then the blocks: odd blocks shifted
    where the stage shifts at all."""

    def __init__(self, spec: SwinVisionSpec, s: int):
        super().__init__()
        self.downsample = (_PatchMerge(spec.stage_dim(s - 1), spec.ln_eps)
                           if s > 0 else None)
        shift = spec.stage_shift(s)
        self.blocks = nn.ModuleList(
            _Block(spec, s, shift if i % 2 == 1 else 0)
            for i in range(spec.depths[s]))
        w, g = spec.stage_window(s), spec.stage_grid(s)
        self.register_buffer("index", torch.from_numpy(
            rel_pos_index(w).astype(np.int64)), persistent=False)
        self.register_buffer(
            "mask", torch.from_numpy(shift_attn_mask(g, w, shift))
            if shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for block in self.blocks:
            x = block(x, self.index, self.mask)
        return x


class Swin(nn.Module):
    """A Swin tower (the JAX package's `encode_image_swin`)."""

    def __init__(self, spec: SwinVisionSpec):
        super().__init__()
        self.spec = spec
        D = spec.embed_dim
        last = spec.stage_dim(len(spec.depths) - 1)
        self.patch_embedding = nn.Parameter(
            torch.zeros(spec.patch_size ** 2 * 3, D))
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.patch_norm = layers.LayerNorm(D, spec.ln_eps)
        self.stages = nn.ModuleList(_Stage(spec, s)
                                    for s in range(len(spec.depths)))
        self.ln_post = layers.LayerNorm(last, spec.ln_eps)
        self.proj = nn.Parameter(torch.zeros(last, spec.output_dim))
        self.register_parameter(
            "proj_bias", nn.Parameter(torch.zeros(spec.output_dim))
            if spec.proj_bias else None)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.patch_embedding.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_swin`: normal(0.02) weights and bias
        tables, zero biases, unit LayerNorms."""
        for name, t in self.named_parameters():
            if name.endswith(("_w", "bias_table", "reduction")) \
                    or name in ("patch_embedding", "proj"):
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
        layers.refuse_training("Swin", remat, dropout)
        spec, dt = self.spec, self.dtype
        B = images.shape[0]
        g0 = spec.image_size // spec.patch_size
        x = patchify(images.to(dt), spec.patch_size) \
            @ self.patch_embedding.to(dt) + self.patch_bias.to(dt)
        x = self.patch_norm(x).reshape(B, g0, g0, spec.embed_dim)
        for stage in self.stages:
            x = stage(x)
        pooled = self.ln_post(x).mean(dim=(1, 2))      # timm's average pool
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


def timm_swin_to_params(sd: Mapping[str, Any], spec: SwinVisionSpec,
                        trunk_prefix: str = "visual.trunk.",
                        head_prefix: str = "visual.head.") -> Params:
    """timm SwinTransformer state dict -> the JAX package's pytree.

    Both key layouts: the rewritten timm stage (the merge at
    `layers.{s}.downsample`, applied at the entry of stage s >= 1) and the
    original one (`layers.{s}.downsample` after stage s's blocks, s <= 2):
    the graphs are the same, only the index the merge is filed under
    differs, so the old keys shift to s + 1."""
    def g(k):
        return _np(sd[trunk_prefix + k])

    old_layout = (trunk_prefix + "layers.0.downsample.reduction.weight") in sd

    def stage(s):
        L = spec.depths[s]
        pre = f"layers.{s}."

        def stack(fmt, transpose=False):
            per = [g(pre + fmt.format(i)) for i in range(L)]
            return np.stack([w.T for w in per] if transpose else per)

        def ln(fmt):
            return {"scale": stack(fmt + ".weight"),
                    "bias": stack(fmt + ".bias")}

        st = {"blocks": {
            "ln_1": ln("blocks.{}.norm1"),
            "attn": {
                "qkv_w": stack("blocks.{}.attn.qkv.weight", True),
                "qkv_b": stack("blocks.{}.attn.qkv.bias"),
                "out_w": stack("blocks.{}.attn.proj.weight", True),
                "out_b": stack("blocks.{}.attn.proj.bias"),
                "bias_table": stack(
                    "blocks.{}.attn.relative_position_bias_table")},
            "ln_2": ln("blocks.{}.norm2"),
            "mlp": {"fc_w": stack("blocks.{}.mlp.fc1.weight", True),
                    "fc_b": stack("blocks.{}.mlp.fc1.bias"),
                    "proj_w": stack("blocks.{}.mlp.fc2.weight", True),
                    "proj_b": stack("blocks.{}.mlp.fc2.bias")}}}
        if s > 0:
            ds = f"layers.{s - 1}." if old_layout else f"layers.{s}."
            st["downsample"] = {
                "norm": {"scale": g(ds + "downsample.norm.weight"),
                         "bias": g(ds + "downsample.norm.bias")},
                "reduction": g(ds + "downsample.reduction.weight").T}
        return st

    conv = g("patch_embed.proj.weight")
    ps = conv.shape[-1]
    out = {
        "patch_embedding": conv.transpose(2, 3, 1, 0).reshape(ps * ps * 3, -1),
        "patch_bias": g("patch_embed.proj.bias"),
        "patch_norm": {"scale": g("patch_embed.norm.weight"),
                       "bias": g("patch_embed.norm.bias")},
        "stages": [stage(s) for s in range(len(spec.depths))],
        "ln_post": {"scale": g("norm.weight"), "bias": g("norm.bias")},
        "proj": _np(sd[head_prefix + "proj.weight"]).T,
    }
    if head_prefix + "proj.bias" in sd:
        out["proj_bias"] = _np(sd[head_prefix + "proj.bias"])
    return out


from leaf_tpu_torch.models.trunks import register_trunk  # noqa: E402

register_trunk(SwinVisionSpec, Swin, timm_swin_to_params, match_swin)
