"""MobileCLIP image trunks, timm's `vit_base_mci_224` and
`fastvit_mci1/2` (port of `leaf_tpu/models/mci.py`).

The trunks behind OpenCLIP's `model_configs/MobileCLIP-{B,S1,S2}.json`,
whose `timm_proj: null` makes the trunk's classifier the CLIP projection:

  * **MCi-ViT** (MobileCLIP-B), `MciViT`: a ViT-B/16 whose patchify is a
    conv stem of three kernel = stride convolutions with GELU (timm's
    `ConvStem`, its BatchNorms folded in), then the 1x1 projection;
    `no_embed_class` positions (patch tokens only), the class token
    prepended after them; the blocks run the fused attention block with
    `packed=(T, False)` and LN eps 1e-6, exact-erf GELU; `ln_post`, the
    class-token pool and the trunk head.
  * **FastViT** (MobileCLIP-S1/S2), `FastVit`, in its DEPLOY form: every
    multi-branch train-time block (MobileOneBlock, RepMixer, RepCPE,
    ReparamLargeKernelConv) is one convolution, with squeeze-excite where
    timm has it; four stages (RepMixer x 3, attention), the final conv, an
    average pool and the head.  Convolutions are `F.conv2d`, as the JAX
    package runs them as `lax.conv` outside any Pallas kernel, and the
    attention stage's `_attention` is plain matmul/softmax with fp32
    logits: FastViT launches none of the port's kernels.

Images come in NHWC; the modules compute in NCHW (a permuted view, which
keeps channels-last strides for the convolutions) with OIHW kernels.  The
JAX package holds HWIO kernels: `interop.params_from_jax` transposes every
4-D leaf of a `visual` pytree to OIHW, and that is where the two layouts
meet.

Checkpoints: `timm_fastvit_to_params` and `timm_mci_vit_to_params` are the
JAX package's numpy ingestion, copied: the exact branch fusion at load time
(conv + BN folding, 1x1 -> kxk centre padding, identity as a conv), from
timm's train-form keys (`conv_kxk.0.{conv,bn}`, `conv_scale`, `identity`,
`token_mixer.{mixer,norm}`, `layer_scale.gamma`, ...) or deploy-form ones
(`reparam_conv`).  They return the JAX package's pytree (HWIO).

Training these trunks (their backward, `remat`, patch dropout) is not
ported: `encode_image` raises for it (ROADMAP Queue 1 item 11 step 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from leaf_tpu_torch.models import layers
from leaf_tpu_torch.models.timm_vision import timm_vit_blocks_to_stack

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MciViTSpec:
    """vit_base_mci_224 — hybrid ViT-B with the MCi conv stem."""
    name: str
    image_size: int = 224
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    stem_channels: Tuple[int, ...] = (192, 192, 768)
    stem_kernels: Tuple[int, ...] = (4, 2, 2)
    output_dim: int = 512
    ln_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        s = 1
        for k in self.stem_kernels:
            s *= k
        return self.image_size // s


@dataclasses.dataclass(frozen=True)
class FastVitSpec:
    """fastvit_mci1 / fastvit_mci2 — MobileCLIP S1/S2 image towers."""
    name: str
    image_size: int = 256
    dims: Tuple[int, ...] = (64, 128, 256, 512)
    depths: Tuple[int, ...] = (4, 12, 24, 4)
    mlp_ratio: float = 3.0
    # per stage: "repmixer" | "attention"
    token_mixers: Tuple[str, ...] = ("repmixer", "repmixer", "repmixer",
                                     "attention")
    se_downsamples: Tuple[bool, ...] = (False, False, True, True)
    pos_emb_stages: Tuple[int, ...] = (3,)   # RepCPE at these stage entries
    attn_head_dim: int = 32
    cls_ratio: float = 2.0                   # final conv dim multiplier
    output_dim: int = 512

    @property
    def final_dim(self) -> int:
        return int(self.dims[-1] * self.cls_ratio)


MCI_TRUNKS = {
    "vit_base_mci_224": ("vit", dict()),
    "fastvit_mci1": ("fastvit", dict(
        dims=(64, 128, 256, 512), depths=(4, 12, 24, 4))),
    "fastvit_mci2": ("fastvit", dict(
        dims=(80, 160, 320, 640), depths=(4, 12, 24, 4))),
}


def match_mci(name: str, embed_dim: int, image_size: Optional[int] = None,
              pool: str = "", proj=None):
    if name not in MCI_TRUNKS:
        if name.startswith("fastvit") or "_mci" in name:
            raise ValueError(
                f"unsupported MobileCLIP trunk {name!r}; implemented: "
                f"{sorted(MCI_TRUNKS)}")
        return None
    kind, kw = MCI_TRUNKS[name]
    kw = dict(kw)
    if image_size:
        kw["image_size"] = image_size
    cls = MciViTSpec if kind == "vit" else FastVitSpec
    return cls(name=name, output_dim=embed_dim, **kw)


# ---------------------------------------------------------------------------
# Shared parts (NCHW activations, OIHW kernels)
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          stride: int = 1, groups: int = 1,
          padding: Optional[int] = None) -> torch.Tensor:
    """`F.conv2d` in the activations' dtype; `padding` defaults to k // 2."""
    k = w.shape[-1]
    return F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                    stride, k // 2 if padding is None else padding, 1, groups)


def _channels(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector [C] as [C, 1, 1] in x's dtype."""
    return v.to(x.dtype)[:, None, None]


def _he(t: torch.Tensor, generator: torch.Generator) -> None:
    """Fan-in-scaled normal draw for an OIHW kernel (the JAX package's
    `_he`: the deploy form has no BN to renormalise activations)."""
    fan_in = t.shape[1] * t.shape[2] * t.shape[3]
    layers.normal_(t, (2.0 / fan_in) ** 0.5, generator)


def _dw_identity_(t: torch.Tensor) -> None:
    """Add the depthwise identity kernel to an OIHW [C, 1, k, k] tensor."""
    k = t.shape[-1]
    with torch.no_grad():
        t[:, 0, k // 2, k // 2] += 1.0


class _SE(nn.Module):
    """Squeeze-excite: mean over the grid, 1x1 -> relu -> 1x1 -> sigmoid."""

    def __init__(self, c: int, rd: float = 0.0625):
        super().__init__()
        r = max(1, int(c * rd))
        self.fc1_w = nn.Parameter(torch.zeros(r, c, 1, 1))
        self.fc1_b = nn.Parameter(torch.zeros(r))
        self.fc2_w = nn.Parameter(torch.zeros(c, r, 1, 1))
        self.fc2_b = nn.Parameter(torch.zeros(c))

    def init_weights(self, generator: torch.Generator) -> None:
        layers.normal_(self.fc1_w, 0.02, generator)
        layers.normal_(self.fc2_w, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.relu(_conv(s, self.fc1_w, self.fc1_b, padding=0))
        return x * torch.sigmoid(_conv(s, self.fc2_w, self.fc2_b, padding=0))


class _Mob(nn.Module):
    """Deploy-form MobileOneBlock: one conv (+ SE) (+ GELU)."""

    def __init__(self, k: int, cin: int, cout: int, groups: int = 1,
                 stride: int = 1, se: bool = False,
                 padding: Optional[int] = None, act: bool = True):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.b = nn.Parameter(torch.zeros(cout))
        self.se = _SE(cout) if se else None
        self.stride, self.groups, self.padding = stride, groups, padding
        self.act = act

    def init_weights(self, generator: torch.Generator) -> None:
        _he(self.w, generator)
        if self.se is not None:
            self.se.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(x, self.w, self.b, self.stride, self.groups, self.padding)
        if self.se is not None:
            y = self.se(y)
        return layers.gelu(y) if self.act else y


def _finish(pooled: torch.Tensor, normalize: bool) -> torch.Tensor:
    from leaf_tpu_torch.models.clip import l2_normalize
    return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# MCi-ViT
# ---------------------------------------------------------------------------

class MciViT(nn.Module):
    """The MCi hybrid ViT (the JAX package's `encode_image_mci_vit`)."""

    def __init__(self, spec: MciViTSpec):
        super().__init__()
        self.spec = spec
        D = spec.width
        chans = (3,) + spec.stem_channels
        self.stem = nn.ModuleList(
            _Mob(k, chans[i], chans[i + 1], stride=k, padding=0)
            for i, k in enumerate(spec.stem_kernels))
        self.proj_w = nn.Parameter(torch.zeros(D, spec.stem_channels[-1], 1, 1))
        self.proj_b = nn.Parameter(torch.zeros(D))
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.positional_embedding = nn.Parameter(
            torch.zeros(spec.grid_size ** 2, D))
        self.blocks = layers.Transformer(D, spec.layers, spec.heads,
                                         int(D * spec.mlp_ratio), layers.gelu,
                                         spec.ln_eps)
        self.ln_post = layers.LayerNorm(D, spec.ln_eps)
        self.proj = nn.Parameter(torch.zeros(D, spec.output_dim))
        self.proj_bias = nn.Parameter(torch.zeros(spec.output_dim))
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.proj_w.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        for st in self.stem:
            st.init_weights(generator)
        for t in (self.proj_w, self.class_embedding,
                  self.positional_embedding, self.proj):
            layers.normal_(t, 0.02, generator)
        self.blocks.init_weights(generator)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        layers.refuse_training("MobileCLIP", remat, dropout)
        dtype = self.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        for st in self.stem:            # kernel == stride, pad 0, GELU
            x = st(x)
        x = _conv(x, self.proj_w, self.proj_b, padding=0)          # 1x1
        x = x.flatten(2).transpose(1, 2)                           # [B, N, D]
        # no_embed_class: positions on the patch tokens, the class token after
        x = x + self.positional_embedding.to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = self.blocks(x, packed=(x.shape[1], False))
        pooled = self.ln_post(x)[:, 0]                             # token pool
        pooled = pooled @ self.proj.to(dtype) + self.proj_bias.to(dtype)
        return _finish(pooled, normalize)


# ---------------------------------------------------------------------------
# FastViT (deploy form)
# ---------------------------------------------------------------------------

class _ConvMlp(nn.Module):
    """ConvMlp: the fused dw 7x7 conv, then 1x1 fc1 -> GELU -> 1x1 fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.conv_w = nn.Parameter(torch.zeros(dim, 1, 7, 7))
        self.conv_b = nn.Parameter(torch.zeros(dim))
        self.fc1_w = nn.Parameter(torch.zeros(hidden, dim, 1, 1))
        self.fc1_b = nn.Parameter(torch.zeros(hidden))
        self.fc2_w = nn.Parameter(torch.zeros(dim, hidden, 1, 1))
        self.fc2_b = nn.Parameter(torch.zeros(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        for t in (self.conv_w, self.fc1_w, self.fc2_w):
            _he(t, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(x, self.conv_w, self.conv_b, groups=x.shape[1])
        y = layers.gelu(_conv(y, self.fc1_w, self.fc1_b, padding=0))
        return _conv(y, self.fc2_w, self.fc2_b, padding=0)


class _RepMixerBlock(nn.Module):
    """Deploy RepMixer: the residual and layer scale folded into one dw 3x3
    conv, then the layer-scaled ConvMlp residual."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.mixer_w = nn.Parameter(torch.zeros(dim, 1, 3, 3))
        self.mixer_b = nn.Parameter(torch.zeros(dim))
        self.ls2 = nn.Parameter(torch.zeros(dim))
        self.mlp = _ConvMlp(dim, hidden)

    def init_weights(self, generator: torch.Generator) -> None:
        # I + gamma (W_mixer - W_norm) with gamma = 1e-5: near the identity
        layers.normal_(self.mixer_w, 0.02 * 1e-3, generator)
        _dw_identity_(self.mixer_w)
        nn.init.constant_(self.ls2, 1e-5)
        self.mlp.init_weights(generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = _conv(h, self.mixer_w, self.mixer_b, groups=h.shape[1])
        return h + _channels(self.ls2, h) * self.mlp(h)


class _AttnBlock(nn.Module):
    """The attention stage's block: BN (a folded per-channel affine),
    multi-head attention over the grid, the layer-scaled ConvMlp."""

    def __init__(self, dim: int, hidden: int, head_dim: int):
        super().__init__()
        self.head_dim = head_dim
        self.norm = nn.ParameterDict({"scale": nn.Parameter(torch.ones(dim)),
                                      "bias": nn.Parameter(torch.zeros(dim))})
        self.attn = nn.ParameterDict({
            "qkv_w": nn.Parameter(torch.zeros(dim, 3 * dim)),
            "proj_w": nn.Parameter(torch.zeros(dim, dim)),
            "proj_b": nn.Parameter(torch.zeros(dim))})
        self.ls1 = nn.Parameter(torch.zeros(dim))
        self.ls2 = nn.Parameter(torch.zeros(dim))
        self.mlp = _ConvMlp(dim, hidden)

    def init_weights(self, generator: torch.Generator) -> None:
        layers.normal_(self.attn["qkv_w"], 0.02, generator)
        layers.normal_(self.attn["proj_w"], 0.02, generator)
        nn.init.constant_(self.ls1, 1e-5)
        nn.init.constant_(self.ls2, 1e-5)
        self.mlp.init_weights(generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # timm's attention may or may not carry a qkv bias
        layers.adopt_optional(self.attn, "qkv_b", state_dict,
                              prefix + "attn.qkv_b")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        n_heads, hd = C // self.head_dim, self.head_dim
        p = {k: v.to(x.dtype) for k, v in self.attn.items()}
        t = x.flatten(2).transpose(1, 2)                           # [B, HW, C]
        qkv = t @ p["qkv_w"]
        if "qkv_b" in p:
            qkv = qkv + p["qkv_b"]
        q, k, v = (z.reshape(B, H * W, n_heads, hd).transpose(1, 2)
                   for z in qkv.split(C, dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(1, 2).reshape(B, H * W, C) @ p["proj_w"] \
            + p["proj_b"]
        return out.transpose(1, 2).reshape(B, C, H, W)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        y = h * _channels(self.norm["scale"], h) \
            + _channels(self.norm["bias"], h)
        h = h + _channels(self.ls1, h) * self._attention(y)
        return h + _channels(self.ls2, h) * self.mlp(h)


class _Stage(nn.Module):
    def __init__(self, spec: FastVitSpec, s: int):
        super().__init__()
        C = spec.dims[s]
        hidden = int(C * spec.mlp_ratio)
        self.downsample = None
        if s > 0:
            cin = spec.dims[s - 1]
            # ReparamLargeKernelConv: grouped 7x7 s2 (+ SE) + GELU, then a
            # pointwise MobileOneBlock
            self.downsample = nn.ModuleDict({
                "lkc": _Mob(7, cin, C, groups=cin, stride=2,
                            se=spec.se_downsamples[s]),
                "pw": _Mob(1, C, C, padding=0)})
        self.pos_emb = None
        if s in spec.pos_emb_stages:
            # RepCPE, its identity folded into the dw 7x7 conv
            self.pos_emb = nn.ParameterDict({
                "w": nn.Parameter(torch.zeros(C, 1, 7, 7)),
                "b": nn.Parameter(torch.zeros(C))})
        self.blocks = nn.ModuleList(
            _RepMixerBlock(C, hidden) if spec.token_mixers[s] == "repmixer"
            else _AttnBlock(C, hidden, spec.attn_head_dim)
            for _ in range(spec.depths[s]))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.downsample is not None:
            self.downsample["lkc"].init_weights(generator)
            self.downsample["pw"].init_weights(generator)
        if self.pos_emb is not None:
            layers.normal_(self.pos_emb["w"], 0.02, generator)
            _dw_identity_(self.pos_emb["w"])
        for block in self.blocks:
            block.init_weights(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample["pw"](self.downsample["lkc"](x))
        if self.pos_emb is not None:
            x = _conv(x, self.pos_emb["w"], self.pos_emb["b"],
                      groups=x.shape[1])
        for block in self.blocks:
            x = block(x)
        return x


class FastVit(nn.Module):
    """FastViT in deploy form (the JAX package's `encode_image_fastvit`)."""

    def __init__(self, spec: FastVitSpec):
        super().__init__()
        self.spec = spec
        d0, fin = spec.dims[0], spec.final_dim
        self.stem = nn.ModuleList([
            _Mob(3, 3, d0, stride=2),
            _Mob(3, d0, d0, groups=d0, stride=2),
            _Mob(1, d0, d0, padding=0)])
        self.stages = nn.ModuleList(_Stage(spec, s)
                                    for s in range(len(spec.depths)))
        self.final = _Mob(3, spec.dims[-1], fin, groups=spec.dims[-1], se=True)
        self.head_w = nn.Parameter(torch.zeros(fin, spec.output_dim))
        self.head_b = nn.Parameter(torch.zeros(spec.output_dim))
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.head_w.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        for m in list(self.stem) + list(self.stages) + [self.final]:
            m.init_weights(generator)
        layers.normal_(self.head_w, 0.02, generator)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        layers.refuse_training("MobileCLIP", remat, dropout)
        dtype = self.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        for m in list(self.stem) + list(self.stages) + [self.final]:
            x = m(x)
        pooled = x.mean(dim=(2, 3))
        pooled = pooled @ self.head_w.to(dtype) + self.head_b.to(dtype)
        return _finish(pooled, normalize)


# ---------------------------------------------------------------------------
# Checkpoint ingestion: structural reparameterization (the JAX package's
# numpy code, copied; it returns that package's pytree, HWIO kernels)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def fuse_conv_bn(w: np.ndarray, gamma, beta, mean, var,
                 eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """BN-after-conv folding (torch OIHW weight) → (w', b')."""
    s = gamma / np.sqrt(var + eps)
    return w * s[:, None, None, None], beta - mean * s


def _identity_kernel(c_out: int, c_in: int, groups: int,
                     k: int) -> np.ndarray:
    """Identity map as an OIHW conv kernel (requires c_in == c_out)."""
    inp = c_in // groups
    w = np.zeros((c_out, inp, k, k), np.float32)
    for o in range(c_out):
        w[o, o % inp, k // 2, k // 2] = 1.0
    return w


def _pad_1x1_to_kxk(w: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros(w.shape[:2] + (k, k), np.float32)
    out[:, :, k // 2, k // 2] = w[:, :, 0, 0]
    return out


def _hwio(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)


class _SD:
    """Key-probing view over a state dict with a fixed prefix."""

    def __init__(self, sd: Mapping[str, Any], prefix: str):
        self.sd, self.prefix = sd, prefix

    def has(self, k: str) -> bool:
        return self.prefix + k in self.sd

    def get(self, k: str) -> np.ndarray:
        full = self.prefix + k
        if full not in self.sd:
            raise KeyError(
                f"MobileCLIP ingestion: missing key {full!r} "
                "(expected timm train-form or deploy-form layout; "
                "Apple-format checkpoints must first be remapped to timm's "
                "keys, as OpenCLIP's MobileCLIP conversion does)")
        return _np(self.sd[full])

    def sub(self, k: str) -> "_SD":
        return _SD(self.sd, self.prefix + k)


def _fuse_branch(g: _SD, name: str):
    """One conv+BN branch → fused (OIHW, bias); conv may be bias-less."""
    w = g.get(name + ".conv.weight")
    return fuse_conv_bn(w, g.get(name + ".bn.weight"),
                        g.get(name + ".bn.bias"),
                        g.get(name + ".bn.running_mean"),
                        g.get(name + ".bn.running_var"))


def _fuse_mobileone(g: _SD, k: int, groups: int) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """MobileOneBlock branches → single fused (OIHW, bias).

    Branches: `conv_kxk.{i}` (conv+BN), `conv_scale` (1×1 conv+BN,
    center-padded to k×k), `identity` (bare BN over the skip).  Deploy
    checkpoints carry `reparam_conv` directly."""
    if g.has("reparam_conv.weight"):
        return (g.get("reparam_conv.weight"), g.get("reparam_conv.bias"))
    w_sum = None
    b_sum = None
    i = 0
    while g.has(f"conv_kxk.{i}.conv.weight"):
        w, b = _fuse_branch(g, f"conv_kxk.{i}")
        w_sum = w if w_sum is None else w_sum + w
        b_sum = b if b_sum is None else b_sum + b
        i += 1
    if w_sum is None:
        raise KeyError(
            f"MobileCLIP ingestion: no conv_kxk.0/reparam_conv under "
            f"{g.prefix!r}")
    if g.has("conv_scale.conv.weight"):
        w, b = _fuse_branch(g, "conv_scale")
        w_sum = w_sum + _pad_1x1_to_kxk(w, k)
        b_sum = b_sum + b
    if g.has("identity.weight"):         # bare BN skip branch
        c = w_sum.shape[0]
        wid = _identity_kernel(c, c, groups, k)
        w, b = fuse_conv_bn(wid, g.get("identity.weight"),
                            g.get("identity.bias"),
                            g.get("identity.running_mean"),
                            g.get("identity.running_var"))
        w_sum = w_sum + w
        b_sum = b_sum + b
    return w_sum, b_sum


def _mob_params(g: _SD, k: int, groups: int) -> Params:
    w, b = _fuse_mobileone(g, k, groups)
    p = {"w": _hwio(w), "b": b}
    if g.has("se.fc1.weight"):
        p["se"] = {"fc1_w": _hwio(g.get("se.fc1.weight")),
                   "fc1_b": g.get("se.fc1.bias"),
                   "fc2_w": _hwio(g.get("se.fc2.weight")),
                   "fc2_b": g.get("se.fc2.bias")}
    return p


def _fuse_repmixer(g: _SD, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """RepMixer → single dw3×3: I + γ·(mixer − norm) (exact: both
    branches are conv+BN, the skip is identity, γ the layer scale)."""
    if g.has("reparam_conv.weight"):
        return g.get("reparam_conv.weight"), g.get("reparam_conv.bias")
    wm, bm = _fuse_mobileone(g.sub("mixer."), 3, dim)
    wn, bn = _fuse_mobileone(g.sub("norm."), 3, dim)
    if g.has("layer_scale.gamma"):
        ls = g.get("layer_scale.gamma").reshape(-1)
    else:
        ls = np.ones(dim, np.float32)
    w = ls[:, None, None, None] * (wm - wn)
    b = ls * (bm - bn)
    w = w + _identity_kernel(dim, dim, dim, 3)
    return w, b


def _fuse_repcpe(g: _SD, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """RepCPE (dw conv + identity residual) → single conv."""
    if g.has("reparam_conv.weight"):
        return g.get("reparam_conv.weight"), g.get("reparam_conv.bias")
    for cand in ("pe.0", "proj", "pe"):
        if g.has(cand + ".weight"):
            w = g.get(cand + ".weight")
            b = (g.get(cand + ".bias") if g.has(cand + ".bias")
                 else np.zeros(dim, np.float32))
            k = w.shape[-1]
            return w + _identity_kernel(dim, dim, dim, k), b
    raise KeyError(f"MobileCLIP ingestion: no RepCPE conv under {g.prefix!r}")


def _ls(g: _SD, name: str, dim: int) -> np.ndarray:
    if g.has(name + ".gamma"):
        return g.get(name + ".gamma").reshape(-1)
    return np.ones(dim, np.float32)


def timm_fastvit_to_params(sd: Mapping[str, Any], spec: FastVitSpec,
                           trunk_prefix: str = "visual.trunk.",
                           head_prefix: str = "visual.head.") -> Params:
    """timm FastVit state dict (train- or deploy-form) → fused pytree."""
    root = _SD(sd, trunk_prefix)
    d0 = spec.dims[0]
    stem = [_mob_params(root.sub("stem.0."), 3, 1),
            _mob_params(root.sub("stem.1."), 3, d0),
            _mob_params(root.sub("stem.2."), 1, 1)]

    def stage(s):
        L, C = spec.depths[s], spec.dims[s]
        pre = f"stages.{s}."
        st: Params = {}
        if s > 0:
            Cin = spec.dims[s - 1]
            ds = root.sub(pre + "downsample.")
            st["downsample"] = {
                "lkc": _lkc_params(ds.sub("proj.0."), Cin),
                "pw": _mob_params(ds.sub("proj.1."), 1, 1)}
        if s in spec.pos_emb_stages:
            w, b = _fuse_repcpe(root.sub(pre + "pos_emb."), C)
            st["pos_emb"] = {"w": _hwio(w), "b": b}

        def blk(j):
            return root.sub(pre + f"blocks.{j}.")

        def stack(fn):
            ws, bs = zip(*(fn(blk(j)) for j in range(L)))
            return np.stack(ws), np.stack(bs)

        def mlp_params():
            conv = [_fuse_branch(blk(j), "mlp.conv")
                    if blk(j).has("mlp.conv.conv.weight")
                    else (blk(j).get("mlp.conv.weight"),
                          blk(j).get("mlp.conv.bias"))
                    for j in range(L)]
            return {
                "conv_w": np.stack([_hwio(w) for w, _ in conv]),
                "conv_b": np.stack([b for _, b in conv]),
                "fc1_w": np.stack([_hwio(blk(j).get("mlp.fc1.weight"))
                                   for j in range(L)]),
                "fc1_b": np.stack([blk(j).get("mlp.fc1.bias")
                                   for j in range(L)]),
                "fc2_w": np.stack([_hwio(blk(j).get("mlp.fc2.weight"))
                                   for j in range(L)]),
                "fc2_b": np.stack([blk(j).get("mlp.fc2.bias")
                                   for j in range(L)]),
            }

        if spec.token_mixers[s] == "repmixer":
            mw, mb = stack(lambda b: _fuse_repmixer(b.sub("token_mixer."),
                                                    C))
            st["blocks"] = {
                "mixer_w": np.stack([_hwio(w) for w in mw]),
                "mixer_b": mb,
                "ls2": np.stack([_ls(blk(j), "layer_scale", C)
                                 for j in range(L)]),
                "mlp": mlp_params()}
        else:
            norm = [_bn_affine(blk(j), "norm") for j in range(L)]
            attn = {
                "qkv_w": np.stack(
                    [blk(j).get("token_mixer.qkv.weight").T
                     for j in range(L)]),
                "proj_w": np.stack(
                    [blk(j).get("token_mixer.proj.weight").T
                     for j in range(L)]),
                "proj_b": np.stack(
                    [blk(j).get("token_mixer.proj.bias")
                     for j in range(L)]),
            }
            if blk(0).has("token_mixer.qkv.bias"):
                attn["qkv_b"] = np.stack(
                    [blk(j).get("token_mixer.qkv.bias") for j in range(L)])
            st["blocks"] = {
                "norm": {"scale": np.stack([n[0] for n in norm]),
                         "bias": np.stack([n[1] for n in norm])},
                "attn": attn,
                "ls1": np.stack([_ls(blk(j), "layer_scale_1", C)
                                 for j in range(L)]),
                "ls2": np.stack([_ls(blk(j), "layer_scale_2", C)
                                 for j in range(L)]),
                "mlp": mlp_params()}
        return st

    return {
        "stem": stem,
        "stages": [stage(s) for s in range(len(spec.depths))],
        "final": _mob_params(root.sub("final_conv."), 3, spec.dims[-1]),
        "head_w": _np(sd[trunk_prefix + "head.fc.weight"]).T
        if trunk_prefix + "head.fc.weight" in sd
        else _np(sd[trunk_prefix + "head.weight"]).T,
        "head_b": _np(sd[trunk_prefix + "head.fc.bias"])
        if trunk_prefix + "head.fc.bias" in sd
        else _np(sd[trunk_prefix + "head.bias"]),
    }


def _lkc_params(g: _SD, groups: int) -> Params:
    """ReparamLargeKernelConv: large (7×7) + small (3×3) conv+BN
    branches → one fused 7×7 (small branch center-padded)."""
    if g.has("reparam_conv.weight"):
        p = {"w": _hwio(g.get("reparam_conv.weight")),
             "b": g.get("reparam_conv.bias")}
    else:
        w, b = _fuse_branch(g, "large_conv")
        if g.has("small_conv.conv.weight"):
            ws, bs = _fuse_branch(g, "small_conv")
            pad = (w.shape[-1] - ws.shape[-1]) // 2
            w = w + np.pad(ws, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
            b = b + bs
        p = {"w": _hwio(w), "b": b}
    if g.has("se.fc1.weight"):
        p["se"] = {"fc1_w": _hwio(g.get("se.fc1.weight")),
                   "fc1_b": g.get("se.fc1.bias"),
                   "fc2_w": _hwio(g.get("se.fc2.weight")),
                   "fc2_b": g.get("se.fc2.bias")}
    return p


def _bn_affine(g: _SD, name: str, eps: float = 1e-5):
    """Inference BN2d → per-channel (scale, bias)."""
    gam = g.get(name + ".weight")
    bet = g.get(name + ".bias")
    mean = g.get(name + ".running_mean")
    var = g.get(name + ".running_var")
    s = gam / np.sqrt(var + eps)
    return s, bet - mean * s


def timm_mci_vit_to_params(sd: Mapping[str, Any], spec: MciViTSpec,
                           trunk_prefix: str = "visual.trunk.",
                           head_prefix: str = "visual.head.") -> Params:
    """timm hybrid-ViT (ConvStem backbone) state dict → pytree.

    Key layout: `patch_embed.backbone.{i}.{conv,bn}`, `patch_embed.proj`
    (1×1), `cls_token`, `pos_embed` (patch tokens only —
    no_embed_class), `blocks.*` (standard timm ViT), `norm`, `head`."""
    root = _SD(sd, trunk_prefix)
    stem = []
    for i in range(len(spec.stem_kernels)):
        g = root.sub(f"patch_embed.backbone.{i}.")
        if g.has("bn.running_mean"):
            w, b = _fuse_branch(root, f"patch_embed.backbone.{i}")
        else:
            w = g.get("conv.weight")
            b = (g.get("conv.bias") if g.has("conv.bias")
                 else np.zeros(w.shape[0], np.float32))
        stem.append({"w": _hwio(w), "b": b})
    blocks = timm_vit_blocks_to_stack(sd, trunk_prefix, spec.layers)
    return {
        "stem": stem,
        "proj_w": _hwio(root.get("patch_embed.proj.weight")),
        "proj_b": root.get("patch_embed.proj.bias"),
        "class_embedding": root.get("cls_token").reshape(-1),
        "positional_embedding": root.get("pos_embed").reshape(-1, spec.width),
        "blocks": blocks,
        "ln_post": {"scale": root.get("norm.weight"),
                    "bias": root.get("norm.bias")},
        "proj": root.get("head.weight").T,
        "proj_bias": root.get("head.bias"),
    }


def build_mci(spec) -> nn.Module:
    return MciViT(spec) if isinstance(spec, MciViTSpec) else FastVit(spec)


def mci_from_timm(sd, spec, trunk_prefix: str = "visual.trunk.",
                  head_prefix: str = "visual.head.") -> Params:
    if isinstance(spec, MciViTSpec):
        return timm_mci_vit_to_params(sd, spec, trunk_prefix, head_prefix)
    return timm_fastvit_to_params(sd, spec, trunk_prefix, head_prefix)


from leaf_tpu_torch.models.trunks import register_trunk  # noqa: E402

register_trunk(MciViTSpec, build_mci, mci_from_timm, match_mci)
register_trunk(FastVitSpec, build_mci, mci_from_timm)
