"""EVA vision towers: EVA01 giant, EVA02 B/L, EVA02 enormous (port of
`leaf_tpu/models/eva.py`).

The timm trunks behind OpenCLIP's `model_configs/EVA01-g-14*.json` and
`EVA02-*.json` (`timm_pool: "token"`, `timm_proj: null`: the trunk's
classifier is the CLIP projection, with its bias):

  * EVA01 giant: a pre-LN ViT (width 1408, depth 40, MLP 6144) with a
    fused qkv whose k bias is zero;
  * EVA02 B/L: split q/k/v projections with a bias-less k, a 2-D axial
    rotary embedding on q and k (timm's `RotaryEmbeddingCat`,
    `in_pixels=False`; the class token is not rotated), a LayerNorm on the
    attention output before its projection (`ln_inner`) and a SwiGLU MLP
    (silu(gate) * x, hidden = width * 8/3) with a LayerNorm inside it
    (`mlp.ln`);
  * EVA02 enormous: post-norm blocks (x + LN(f(x))) with a GELU MLP.

The attention is plain PyTorch with fp32 logits and softmax, as the JAX
package computes it outside any Pallas kernel; every LayerNorm is the
LayerNorm op: at EVA02-L, `ln_1`, `ln_inner`, `ln_2` and `mlp.ln` (D 2730,
no multiple of a 16-byte piece: the op's general kernel) in each of 24
blocks and `ln_post`, 97 launches an encode, and none of the packed
kernels.  `ln_post` normalises every token, then the class token is
pooled and projected, as in the JAX package.

`timm_eva_to_params` is the JAX package's numpy ingestion, copied: timm's
`patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.N.{norm1, attn,
norm2, mlp}`, `norm`, `head`; a fused `attn.qkv` with `attn.q_bias` and
`attn.v_bias`, or `attn.{q,k,v}_proj`; SwiGLU's `mlp.{fc1_g, fc1_x, norm,
fc2}`; the inner attention LN `attn.norm`.  It returns that package's
pytree (blocks stacked).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.models import layers

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EvaVisionSpec:
    name: str
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    layers: int = 40
    heads: int = 16
    mlp_hidden: int = 6144          # the MLP's hidden width (timm's int())
    output_dim: int = 1024
    swiglu: bool = False            # SwiGLU MLP (timm swiglu_mlp)
    rope: bool = False              # 2-D axial rope on q/k
    inner_attn_ln: bool = False     # LN on the attention output
    mlp_ln: bool = False            # LN inside the MLP
    post_norm: bool = False         # x + norm(f(x)) blocks
    fused_qkv: bool = True          # one qkv matmul (EVA01), or split q/k/v
    # the rope's position rescale target (timm's ref_feat_shape: the
    # pretrain grid)
    ref_feat_size: int = 16
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


# timm_model_name -> spec: the trunks OpenCLIP's EVA configs name
EVA_TRUNKS = {
    "eva_giant_patch14_224": dict(
        patch_size=14, width=1408, layers=40, heads=16, mlp_hidden=6144),
    "eva02_base_patch16_clip_224": dict(
        patch_size=16, width=768, layers=12, heads=12,
        mlp_hidden=int(768 * 4 * 2 / 3), swiglu=True, rope=True,
        inner_attn_ln=True, mlp_ln=True, fused_qkv=False),
    "eva02_large_patch14_clip_224": dict(
        patch_size=14, width=1024, layers=24, heads=16,
        mlp_hidden=int(1024 * 4 * 2 / 3), swiglu=True, rope=True,
        inner_attn_ln=True, mlp_ln=True, fused_qkv=False),
    "eva02_large_patch14_clip_336": dict(
        image_size=336, patch_size=14, width=1024, layers=24, heads=16,
        mlp_hidden=int(1024 * 4 * 2 / 3), swiglu=True, rope=True,
        inner_attn_ln=True, mlp_ln=True, fused_qkv=False),
    "eva02_enormous_patch14_clip_224": dict(
        patch_size=14, width=1792, layers=64, heads=16,
        mlp_hidden=15360, post_norm=True),
}


def match_eva(name: str, embed_dim: int, image_size: Optional[int] = None,
              pool: str = "token", proj=None) -> Optional[EvaVisionSpec]:
    """The trunk registry's matcher: OpenCLIP timm_model_name -> spec."""
    if name not in EVA_TRUNKS:
        if name.startswith("eva"):
            raise ValueError(f"unsupported EVA trunk {name!r}; implemented: "
                             f"{sorted(EVA_TRUNKS)}")
        return None
    kw = dict(EVA_TRUNKS[name])
    if image_size:
        kw["image_size"] = image_size
    return EvaVisionSpec(name=name, output_dim=embed_dim, **kw)


# ---------------------------------------------------------------------------
# Rotary position embedding (timm RotaryEmbeddingCat, in_pixels=False)
# ---------------------------------------------------------------------------

def rope_sin_cos(spec: EvaVisionSpec) -> Optional[np.ndarray]:
    """(2, grid^2, head_dim) float32 sin/cos table, or None without rope.

    Per axis, positions t = arange(g) / g * ref_feat_size (the rescale
    that keeps a fine-tuned resolution on the pretrain grid); head_dim // 4
    frequencies 1 / 10000^(i / num_bands); the row axis's table, then the
    column axis's, each frequency repeated for its (even, odd) pair."""
    if not spec.rope:
        return None
    g, hd = spec.grid_size, spec.head_dim
    num_bands = hd // 4
    bands = 1.0 / (10000.0 ** (np.arange(num_bands, dtype=np.float64)
                               / num_bands))
    t = np.arange(g, dtype=np.float64) / g * spec.ref_feat_size
    ax = np.outer(t, bands)                       # [g, hd // 4]
    h = np.repeat(ax, g, axis=0)                  # rows: [g * g, hd // 4]
    w = np.tile(ax, (g, 1))                       # columns
    freqs = np.repeat(np.concatenate([h, w], axis=-1), 2, axis=-1)
    return np.stack([np.sin(freqs), np.cos(freqs)]).astype(np.float32)


def _rot_pairs(t: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    t2 = t.reshape(*t.shape[:-1], t.shape[-1] // 2, 2)
    return torch.stack([-t2[..., 1], t2[..., 0]], dim=-1).reshape(t.shape)


def _apply_rope(t: torch.Tensor, sin: torch.Tensor,
                cos: torch.Tensor) -> torch.Tensor:
    """t: [B, H, N, hd] patch-token q or k; sin, cos: [N, hd]."""
    return t * cos.to(t.dtype) + _rot_pairs(t) * sin.to(t.dtype)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _Weights(nn.Module):
    """A part whose weights are its own parameters, named as the JAX
    pytree names them (`q_w`, `gate_b`, ...), beside its LayerNorm."""

    def _add(self, **shapes) -> None:
        self.names = tuple(shapes)
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(*shape)))

    def weights(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        return {n: getattr(self, n).to(dtype) for n in self.names}


class _Attention(_Weights):
    """Fused or split q/k/v (k without a bias), rope on the patch tokens,
    fp32 logits and softmax, `ln_inner`, the output projection."""

    def __init__(self, spec: EvaVisionSpec):
        super().__init__()
        D = spec.width
        self.spec = spec
        if spec.fused_qkv:
            self._add(qkv_w=(D, 3 * D), qkv_b=(3 * D,), out_w=(D, D),
                      out_b=(D,))
        else:
            self._add(q_w=(D, D), q_b=(D,), k_w=(D, D), v_w=(D, D),
                      v_b=(D,), out_w=(D, D), out_b=(D,))
        self.ln_inner = (layers.LayerNorm(D, spec.ln_eps)
                         if spec.inner_attn_ln else None)

    def forward(self, x: torch.Tensor,
                rope: Optional[torch.Tensor]) -> torch.Tensor:
        B, S, D = x.shape
        H, hd = self.spec.heads, self.spec.head_dim
        p = self.weights(x.dtype)
        if self.spec.fused_qkv:
            q, k, v = (x @ p["qkv_w"] + p["qkv_b"]).split(D, dim=-1)
        else:
            q = x @ p["q_w"] + p["q_b"]
            k = x @ p["k_w"]
            v = x @ p["v_w"] + p["v_b"]
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        if rope is not None:
            # the class token (index 0) is not rotated
            q = torch.cat([q[:, :, :1], _apply_rope(q[:, :, 1:], *rope)], 2)
            k = torch.cat([k[:, :, :1], _apply_rope(k[:, :, 1:], *rope)], 2)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
            * (hd ** -0.5)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(1, 2).reshape(B, S, D)
        if self.ln_inner is not None:
            out = self.ln_inner(out)
        return out @ p["out_w"] + p["out_b"]


class _Mlp(_Weights):
    """SwiGLU (silu(gate) * x) or GELU, the optional LN inside, fc2."""

    def __init__(self, spec: EvaVisionSpec):
        super().__init__()
        D, Hn = spec.width, spec.mlp_hidden
        self.swiglu = spec.swiglu
        if spec.swiglu:
            self._add(gate_w=(D, Hn), gate_b=(Hn,), x_w=(D, Hn), x_b=(Hn,),
                      proj_w=(Hn, D), proj_b=(D,))
        else:
            self._add(fc_w=(D, Hn), fc_b=(Hn,), proj_w=(Hn, D), proj_b=(D,))
        self.ln = layers.LayerNorm(Hn, spec.ln_eps) if spec.mlp_ln else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.weights(x.dtype)
        if self.swiglu:
            h = torch.nn.functional.silu(x @ p["gate_w"] + p["gate_b"]) \
                * (x @ p["x_w"] + p["x_b"])
        else:
            h = layers.gelu(x @ p["fc_w"] + p["fc_b"])
        if self.ln is not None:
            h = self.ln(h)
        return h @ p["proj_w"] + p["proj_b"]


class _Block(nn.Module):
    def __init__(self, spec: EvaVisionSpec):
        super().__init__()
        self.post_norm = spec.post_norm
        self.ln_1 = layers.LayerNorm(spec.width, spec.ln_eps)
        self.attn = _Attention(spec)
        self.ln_2 = layers.LayerNorm(spec.width, spec.ln_eps)
        self.mlp = _Mlp(spec)

    def forward(self, x: torch.Tensor,
                rope: Optional[torch.Tensor]) -> torch.Tensor:
        if self.post_norm:
            x = x + self.ln_1(self.attn(x, rope))
            return x + self.ln_2(self.mlp(x))
        x = x + self.attn(self.ln_1(x), rope)
        return x + self.mlp(self.ln_2(x))


class Eva(nn.Module):
    """An EVA tower (the JAX package's `encode_image_eva`)."""

    def __init__(self, spec: EvaVisionSpec):
        super().__init__()
        self.spec = spec
        D = spec.width
        self.patch_embedding = nn.Parameter(
            torch.zeros(spec.patch_size ** 2 * 3, D))
        self.patch_bias = nn.Parameter(torch.zeros(D))
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.positional_embedding = nn.Parameter(
            torch.zeros(spec.grid_size ** 2 + 1, D))
        self.blocks = nn.ModuleList(_Block(spec) for _ in range(spec.layers))
        self.ln_post = layers.LayerNorm(D, spec.ln_eps)
        self.proj = nn.Parameter(torch.zeros(D, spec.output_dim))
        self.proj_bias = nn.Parameter(torch.zeros(spec.output_dim))
        table = rope_sin_cos(spec)
        self.register_buffer(
            "rope", None if table is None else torch.tensor(table),
            persistent=False)
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.patch_embedding.dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's `init_eva`: normal(0.02) weights, zero biases,
        unit LayerNorms."""
        weights = [self.patch_embedding, self.class_embedding,
                   self.positional_embedding, self.proj]
        for block in self.blocks:
            for part in (block.attn, block.mlp):
                weights += [getattr(part, n) for n in part.names
                            if n.endswith("_w")]
        for t in weights:
            layers.normal_(t, 0.02, generator)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     remat: bool = False, dropout=None) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, output_dim]."""
        from leaf_tpu_torch.models.clip import l2_normalize, patchify
        layers.refuse_training("EVA", remat, dropout)
        dt = self.dtype
        x = patchify(images.to(dt), self.spec.patch_size) \
            @ self.patch_embedding.to(dt) + self.patch_bias.to(dt)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        for block in self.blocks:
            x = block(x, self.rope)
        pooled = self.ln_post(x)[:, 0]                    # timm_pool 'token'
        pooled = pooled @ self.proj.to(dt) + self.proj_bias.to(dt)
        return l2_normalize(pooled) if normalize else pooled


# ---------------------------------------------------------------------------
# timm state dicts (the JAX package's numpy code, copied)
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def timm_eva_to_params(sd: Mapping[str, Any], spec: EvaVisionSpec,
                       trunk_prefix: str = "visual.trunk.",
                       head_prefix: str = "visual.head.") -> Params:
    """timm Eva state dict -> the JAX package's pytree (blocks stacked)."""
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

    if spec.fused_qkv:
        qkv_b = np.stack([
            np.concatenate([g(f"blocks.{i}.attn.q_bias"),
                            np.zeros(spec.width, np.float32),
                            g(f"blocks.{i}.attn.v_bias")])
            for i in range(L)])
        attn = {"qkv_w": stack("blocks.{}.attn.qkv.weight", True),
                "qkv_b": qkv_b,
                "out_w": stack("blocks.{}.attn.proj.weight", True),
                "out_b": stack("blocks.{}.attn.proj.bias")}
    else:
        attn = {"q_w": stack("blocks.{}.attn.q_proj.weight", True),
                "q_b": stack("blocks.{}.attn.q_proj.bias"),
                "k_w": stack("blocks.{}.attn.k_proj.weight", True),
                "v_w": stack("blocks.{}.attn.v_proj.weight", True),
                "v_b": stack("blocks.{}.attn.v_proj.bias"),
                "out_w": stack("blocks.{}.attn.proj.weight", True),
                "out_b": stack("blocks.{}.attn.proj.bias")}
    if spec.inner_attn_ln:
        attn["ln_inner"] = ln("blocks.{}.attn.norm")
    if spec.swiglu:
        mlp = {"gate_w": stack("blocks.{}.mlp.fc1_g.weight", True),
               "gate_b": stack("blocks.{}.mlp.fc1_g.bias"),
               "x_w": stack("blocks.{}.mlp.fc1_x.weight", True),
               "x_b": stack("blocks.{}.mlp.fc1_x.bias"),
               "proj_w": stack("blocks.{}.mlp.fc2.weight", True),
               "proj_b": stack("blocks.{}.mlp.fc2.bias")}
    else:
        mlp = {"fc_w": stack("blocks.{}.mlp.fc1.weight", True),
               "fc_b": stack("blocks.{}.mlp.fc1.bias"),
               "proj_w": stack("blocks.{}.mlp.fc2.weight", True),
               "proj_b": stack("blocks.{}.mlp.fc2.bias")}
    if spec.mlp_ln:
        mlp["ln"] = ln("blocks.{}.mlp.norm")
    return {
        "patch_embedding": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, -1),
        "patch_bias": g("patch_embed.proj.bias"),
        "class_embedding": g("cls_token").reshape(-1),
        "positional_embedding": g("pos_embed").reshape(-1, spec.width),
        "blocks": {"ln_1": ln("blocks.{}.norm1"), "attn": attn,
                   "ln_2": ln("blocks.{}.norm2"), "mlp": mlp},
        "ln_post": {"scale": g("norm.weight"), "bias": g("norm.bias")},
        "proj": g("head.weight").T,
        "proj_bias": g("head.bias"),
    }


from leaf_tpu_torch.models.trunks import register_trunk  # noqa: E402

register_trunk(EvaVisionSpec, Eva, timm_eva_to_params, match_eva)
