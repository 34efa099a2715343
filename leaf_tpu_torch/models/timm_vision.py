"""timm ViT vision towers (port of `leaf_tpu/models/timm_vision.py`, a
numpy-only module the port keeps its own copy of).

A timm ViT checkpoint is mapped onto the ViT tower of `models/clip.py`
(biased patch embedding, no ln_pre, 'tok'/'avg'/'avg_patch' pooling, the
SigLIP MAP head, a linear or MLP projection head): `timm_vision_config`
gives the tower's `VisionConfig` for a timm name, `timm_vit_to_params` the
JAX package's pytree of its weights, which `interop.params_from_jax`
carries into the port's state dict.

Covered: `vit_{tiny,small,medium,base,large,huge,giant,so400m}_patch*`
trunks with pool in {'tok', 'avg', 'map'} and proj in {'linear', 'mlp',
'none'}, the combinations OpenCLIP's model configs use.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np

_VIT_DIMS = {
    # name-part → (width, layers, head_width, mlp_ratio)
    "tiny": (192, 12, 64, 4.0),
    "small": (384, 12, 64, 4.0),
    "medium": (512, 12, 64, 4.0),
    "base": (768, 12, 64, 4.0),
    "large": (1024, 24, 64, 4.0),
    "huge": (1280, 32, 80, 4.0),
    "giant": (1408, 40, 88, 4.0),
    # SigLIP's shape-optimized 400M trunk (mlp 4304/1152)
    "so400m": (1152, 27, 72, 3.7362),
}

_VIT_RE = re.compile(
    r"^vit_(tiny|small|medium|base|large|huge|giant|so400m)"
    r"_patch(\d+)((?:_[a-z]+)*)(?:_(\d+))?$")


def parse_timm_vit_name(model_name: str):
    """'vit_base_patch16_224' / 'vit_base_patch16_siglip_224' →
    (width, layers, head_width, mlp_ratio, patch, image_size or None,
    variant tags)."""
    m = _VIT_RE.match(model_name)
    if not m:
        raise ValueError(
            f"unsupported timm model {model_name!r}: only the ViT "
            "family maps onto the port's ViT tower (ConvNeXt trunks are "
            "models/convnext.py's, the trunk families models/trunks.py's)")
    width, layers, head_width, mlp_ratio = _VIT_DIMS[m.group(1)]
    patch = int(m.group(2))
    tags = set(filter(None, (m.group(3) or "").split("_")))
    image = int(m.group(4)) if m.group(4) else None
    return width, layers, head_width, mlp_ratio, patch, image, tags


def timm_vision_config(model_name: str, embed_dim: int,
                       image_size: Optional[int] = None,
                       pool: str = "avg", proj: str = "linear",
                       mlp_ratio: Optional[float] = None) -> VisionConfig:
    """VisionConfig for a timm ViT trunk (the arguments of OpenCLIP's
    `TimmModel`).

    SigLIP trunks (`vit_*_siglip_*`) map to a class-token-less tower
    with the MAP attention pool (timm AttentionPoolLatent) and LN eps
    1e-6; `pool='map'` on any trunk selects the MAP head."""
    # imported here: the registry in models/config.py calls this while it
    # is itself being imported
    from leaf_tpu_torch.models.config import VisionConfig
    width, layers, head_width, name_ratio, patch, name_size, tags = \
        parse_timm_vit_name(model_name)
    siglip = "siglip" in tags
    gap = "gap" in tags          # vit_medium_patch16_gap_256: no cls
    attn_pool_head = pool == "map" or (siglip and pool in ("map", ""))
    pool_type = {"tok": "tok", "token": "tok", "avg": "avg_patch",
                 "map": "tok", "": "tok"}.get(pool)
    if gap or (siglip and not attn_pool_head):
        pool_type = "avg"        # no cls token → mean over all tokens
    if pool_type is None:
        raise ValueError(f"unsupported timm pool {pool!r} "
                         "(abs_attn/rot_attn need conv feature maps)")
    return VisionConfig(
        image_size=image_size or name_size or 224,
        patch_size=patch, width=width, layers=layers,
        head_width=head_width,
        mlp_ratio=mlp_ratio if mlp_ratio is not None else name_ratio,
        output_dim=embed_dim,
        pool_type=pool_type, patch_bias=True, ln_pre=False,
        cls_token=not (siglip or gap), attn_pool=attn_pool_head,
        ln_eps=1e-6 if siglip else 1e-5)


def _np(v) -> np.ndarray:
    return (v.detach().cpu().float().numpy() if hasattr(v, "detach")
            else np.asarray(v, np.float32))


def timm_vit_blocks_to_stack(sd: Mapping[str, Any], trunk_prefix: str,
                             n_layers: int) -> Dict[str, Any]:
    """timm ViT `blocks.N.*` keys → the JAX package's stacked-block pytree
    (shared by the generic ViT mapping below and the MCi hybrid ViT,
    models/mci.py)."""
    g = lambda k: _np(sd[trunk_prefix + k])  # noqa: E731
    has = lambda k: (trunk_prefix + k) in sd  # noqa: E731

    def stack(fmt, transpose=False):
        per = []
        for i in range(n_layers):
            w = g(fmt.format(i))
            per.append(w.T if transpose else w)
        return np.stack(per)

    # optional timm features handled exactly at load time:
    #  * qkv_bias=False (vit_medium_*_gap): zero biases
    #  * LayerScale (init_values=...): ls.gamma scales the branch
    #    OUTPUT before the residual add — gamma*(h@W + b) folds into
    #    (W*gamma, b*gamma) column-wise, a lossless reparameterization
    def maybe_bias(fmt, width_fmt):
        if has(fmt.format(0)):
            return stack(fmt)
        w0 = g(width_fmt.format(0))
        return np.zeros((n_layers, w0.shape[0]), np.float32)

    qkv_w = stack("blocks.{}.attn.qkv.weight", True)
    qkv_b = maybe_bias("blocks.{}.attn.qkv.bias", "blocks.{}.attn.qkv.weight")
    out_w = stack("blocks.{}.attn.proj.weight", True)
    out_b = stack("blocks.{}.attn.proj.bias")
    fc_w = stack("blocks.{}.mlp.fc1.weight", True)
    fc_b = stack("blocks.{}.mlp.fc1.bias")
    proj_w = stack("blocks.{}.mlp.fc2.weight", True)
    proj_b = stack("blocks.{}.mlp.fc2.bias")
    if has("blocks.0.ls1.gamma"):
        g1 = stack("blocks.{}.ls1.gamma")      # [L, D]
        g2 = stack("blocks.{}.ls2.gamma")
        out_w = out_w * g1[:, None, :]
        out_b = out_b * g1
        proj_w = proj_w * g2[:, None, :]
        proj_b = proj_b * g2

    return {
        "ln_1": {"scale": stack("blocks.{}.norm1.weight"),
                 "bias": stack("blocks.{}.norm1.bias")},
        "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b,
                 "out_w": out_w, "out_b": out_b},
        "ln_2": {"scale": stack("blocks.{}.norm2.weight"),
                 "bias": stack("blocks.{}.norm2.bias")},
        "mlp": {"fc_w": fc_w, "fc_b": fc_b,
                "proj_w": proj_w, "proj_b": proj_b},
    }


def timm_vit_to_params(sd: Mapping[str, Any], cfg: VisionConfig,
                       trunk_prefix: str = "visual.trunk.",
                       head_prefix: str = "visual.head.",
                       proj: str = "linear") -> Dict[str, Any]:
    """timm vision_transformer state dict → the JAX package's vision pytree.

    Key layout: `patch_embed.proj`, `cls_token`, `pos_embed`,
    `blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}`,
    `norm`; the projection lives either under `visual.head.proj`
    (open_clip extra head), `visual.head.mlp` or as the trunk
    classifier `head` (proj='linear' via num_classes)."""
    g = lambda k: _np(sd[trunk_prefix + k])  # noqa: E731

    conv = g("patch_embed.proj.weight")          # [D, 3, p, p]
    p = conv.shape[-1]
    patch_embedding = conv.transpose(2, 3, 1, 0).reshape(p * p * 3, -1)

    out = {
        "patch_embedding": patch_embedding,
        "patch_bias": g("patch_embed.proj.bias"),
        "positional_embedding": g("pos_embed").reshape(
            -1, cfg.width),
        "blocks": timm_vit_blocks_to_stack(sd, trunk_prefix, cfg.layers),
        "ln_post": {"scale": g("norm.weight"), "bias": g("norm.bias")},
    }
    if trunk_prefix + "cls_token" in sd:
        out["class_embedding"] = g("cls_token").reshape(-1)

    if trunk_prefix + "attn_pool.latent" in sd:
        # SigLIP MAP head (timm AttentionPoolLatent)
        ap = lambda k: g("attn_pool." + k)  # noqa: E731
        out["attn_pool"] = {
            "probe": ap("latent").reshape(1, cfg.width),
            "q_w": ap("q.weight").T, "q_b": ap("q.bias"),
            "kv_w": ap("kv.weight").T, "kv_b": ap("kv.bias"),
            "proj_w": ap("proj.weight").T, "proj_b": ap("proj.bias"),
            "ln": {"scale": ap("norm.weight"), "bias": ap("norm.bias")},
            "mlp": {"fc_w": ap("mlp.fc1.weight").T,
                    "fc_b": ap("mlp.fc1.bias"),
                    "proj_w": ap("mlp.fc2.weight").T,
                    "proj_b": ap("mlp.fc2.bias")},
        }

    if proj == "mlp" and head_prefix + "mlp.fc1.weight" in sd:
        head = {"fc_w": _np(sd[head_prefix + "mlp.fc1.weight"]).T,
                "fc_b": _np(sd[head_prefix + "mlp.fc1.bias"]),
                "proj_w": _np(sd[head_prefix + "mlp.fc2.weight"]).T}
        if head_prefix + "mlp.fc2.bias" in sd:
            head["proj_b"] = _np(sd[head_prefix + "mlp.fc2.bias"])
        out["head_mlp"] = head
    elif head_prefix + "proj.weight" in sd:
        out["proj"] = _np(sd[head_prefix + "proj.weight"]).T
        if head_prefix + "proj.bias" in sd:
            out["proj_bias"] = _np(sd[head_prefix + "proj.bias"])
    elif trunk_prefix + "head.weight" in sd:
        # trunk classifier used as projection (proj unset in config)
        out["proj"] = _np(sd[trunk_prefix + "head.weight"]).T
        if trunk_prefix + "head.bias" in sd:
            out["proj_bias"] = _np(sd[trunk_prefix + "head.bias"])
    # proj == 'none': features pass through at trunk width
    return out
