"""Model configuration registry (port of `leaf_tpu/models/config.py`).

The same frozen dataclasses and the same plain-ViT registry entries
(`ViT-tiny-test`, ViT-S/B/L/H/g/bigG and the OpenAI `-quickgelu`
variants), with the fields the CLIP-ViT towers read.  Other families
(ResNet, ConvNeXt, SigLIP, timm trunks, HF text towers) and the fields
only they set (attention-pool heads, projection biases, per-model image
statistics, ...) come with later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Text tower config (`leaf_tpu.models.config.TextConfig`)."""
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    output_dim: int = 512
    pool_type: str = "argmax"      # 'argmax' (EOT token) | 'first' | 'last'
    no_causal_mask: bool = False
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Vision tower config (`leaf_tpu.models.config.VisionConfig`)."""
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    head_width: int = 64
    mlp_ratio: float = 4.0
    output_dim: int = 512
    ln_eps: float = 1e-5
    # share of the patch tokens dropped at train time (`--force-patch-dropout`)
    patch_dropout: float = 0.0

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid_size * self.grid_size + 1


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    text: TextConfig
    vision: VisionConfig
    quick_gelu: bool = False       # OpenAI-pretrained towers use QuickGELU
    init_logit_scale: float = 2.6592  # ln(1/0.07)


def _cfg(name, embed_dim, v_layers, v_width, v_patch, t_width, t_heads, t_layers,
         v_head_width=64, v_mlp_ratio=4.0, image_size=224, quick_gelu=False) -> CLIPConfig:
    return CLIPConfig(
        name=name,
        embed_dim=embed_dim,
        quick_gelu=quick_gelu,
        text=TextConfig(width=t_width, heads=t_heads, layers=t_layers,
                        output_dim=embed_dim),
        vision=VisionConfig(image_size=image_size, patch_size=v_patch,
                            width=v_width, layers=v_layers,
                            head_width=v_head_width, mlp_ratio=v_mlp_ratio,
                            output_dim=embed_dim),
    )


_REGISTRY = {}
for c in [
    # test-size model (small image size keeps CPU tests fast)
    _cfg("ViT-tiny-test", 64, v_layers=2, v_width=64, v_patch=16,
         t_width=64, t_heads=2, t_layers=2, image_size=64),
    _cfg("ViT-S-32", 384, v_layers=12, v_width=384, v_patch=32,
         t_width=384, t_heads=6, t_layers=12),
    _cfg("ViT-B-32", 512, v_layers=12, v_width=768, v_patch=32,
         t_width=512, t_heads=8, t_layers=12),
    _cfg("ViT-B-16", 512, v_layers=12, v_width=768, v_patch=16,
         t_width=512, t_heads=8, t_layers=12),
    _cfg("ViT-L-14", 768, v_layers=24, v_width=1024, v_patch=14,
         t_width=768, t_heads=12, t_layers=12),
    _cfg("ViT-L-14-336", 768, v_layers=24, v_width=1024, v_patch=14,
         t_width=768, t_heads=12, t_layers=12, image_size=336),
    _cfg("ViT-H-14", 1024, v_layers=32, v_width=1280, v_patch=14,
         t_width=1024, t_heads=16, t_layers=24, v_head_width=80),
    _cfg("ViT-g-14", 1024, v_layers=40, v_width=1408, v_patch=14,
         t_width=1024, t_heads=16, t_layers=24, v_head_width=88,
         v_mlp_ratio=4.3637),
    _cfg("ViT-bigG-14", 1280, v_layers=48, v_width=1664, v_patch=14,
         t_width=1280, t_heads=20, t_layers=32, v_head_width=104,
         v_mlp_ratio=4.9231),
]:
    _REGISTRY[c.name] = c

# OpenAI-pretrained variants use QuickGELU activation
for base in ["ViT-B-32", "ViT-B-16", "ViT-L-14", "ViT-L-14-336"]:
    _REGISTRY[base + "-quickgelu"] = dataclasses.replace(
        _REGISTRY[base], name=base + "-quickgelu", quick_gelu=True)


def list_models() -> Tuple[str, ...]:
    """All registry names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_model_config(name: str) -> CLIPConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {', '.join(list_models())}")
    return _REGISTRY[name]
