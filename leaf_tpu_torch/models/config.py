"""Model configuration registry (port of `leaf_tpu/models/config.py`).

The same frozen dataclasses and the same registry entries: the plain ViTs
(`ViT-tiny-test`, ViT-S/M/B/L/H/g/bigG/e and their `-quickgelu` variants),
SigLIP (`ViT-*-SigLIP*`, `siglip-tiny-test`), CLIPA (`ViT-*-CLIPA*`), the
timm gap-ViT (`vit_medium_patch16_gap_256`), MobileCLIP
(`MobileCLIP-{B,S1,S2}`, `mci-vit-tiny-test`, `fastvit-tiny-test`),
OpenAI's ModifiedResNets (`RN50`, `RN101`, `RN50x4`, their `-quickgelu`
variants, `RN50x16`, `RN50x64`), ConvNeXt (`convnext_*`,
`convnext-tiny-test`), EVA (`EVA01-*`, `EVA02-*`, `eva-tiny-test`),
ViTamin (`ViTamin-*`, `vitamin-tiny-test`), Swin
(`swin_base_patch4_window7_224`, `swin-tiny-test`), RelPos-ViT
(`vit_relpos_medium_patch16_cls_224`, `relpos-tiny-test`) and the HF text
towers (`roberta-ViT-B-32`, `xlm-roberta-{base-ViT-B-32,large-ViT-H-14}`,
`mt5-{base-ViT-B-32,xl-ViT-H-14}`, `nllb-clip-{base,large}[-siglip]`),
registered through `config_from_open_clip_dict` as in the JAX package.

A config's vision tower is a ModifiedResNet where `resnet` is set
(`models/resnet.py`), a ConvNeXt where `convnext` is
(`models/convnext.py`), a timm trunk where `trunk` is (MobileCLIP, EVA,
ViTamin, Swin, RelPos-ViT: a spec of `models/{mci,eva,vitamin,swin,
relpos_vit}.py`, dispatched by `models/trunks.py`), and the ViT tower
otherwise.  Its text tower is an HF model (`models/hf_text.py`) where
`text.hf_model_name` is set, and the native CLIP text tower otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    proj_bias: bool = False
    no_causal_mask: bool = False
    pad_id: int = 0
    ln_eps: float = 1e-5
    # the HF tokenizer a tower was trained with (SigLIP's SentencePiece,
    # CLIPA's BERT vocabulary) and its extra arguments as (key, value)
    # pairs; `factory.get_tokenizer` raises for these (no vocabulary files)
    hf_tokenizer_name: Optional[str] = None
    tokenizer_kwargs: Optional[Tuple[Tuple[str, object], ...]] = None
    # set: the text tower is this HF model (`models/hf_text.HFTextTower`)
    # with its pooler and projection head, not the CLIP text transformer
    hf_model_name: Optional[str] = None
    hf_pooler_type: str = "mean_pooler"
    hf_proj_type: Optional[str] = "linear"

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
    # 'tok' (class token) | 'avg' (all tokens) | 'avg_patch' (patch tokens
    # only: timm's global_pool='avg')
    pool_type: str = "tok"
    ln_eps: float = 1e-5
    # share of the patch tokens dropped at train time (`--force-patch-dropout`)
    patch_dropout: float = 0.0
    # timm ViT towers: biased patch embedding, no pre-transformer LayerNorm
    patch_bias: bool = False
    ln_pre: bool = True
    # SigLIP towers: no class token, the MAP attention-pool head
    cls_token: bool = True
    attn_pool: bool = False
    # CLIPA: pool first, then ln_post on the pooled vector
    final_ln_after_pool: bool = False

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid_size * self.grid_size + (1 if self.cls_token else 0)


@dataclasses.dataclass(frozen=True)
class ResNetVisionSpec:
    """ModifiedResNet tower spec (OpenCLIP's `model_configs/RN50*.json`:
    the vision layers given as a 4-tuple)."""
    layers: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    image_size: int = 224
    output_dim: int = 1024

    @property
    def heads(self) -> int:
        return self.width * 32 // 64


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    embed_dim: int
    text: TextConfig
    vision: VisionConfig
    quick_gelu: bool = False       # OpenAI-pretrained towers use QuickGELU
    init_logit_scale: float = 2.6592  # ln(1/0.07)
    init_logit_bias: Optional[float] = None   # SigLIP's sigmoid-loss bias
    resnet: Optional[ResNetVisionSpec] = None  # set: a ModifiedResNet tower
    # set: a ConvNeXt tower (a `models.convnext.ConvNeXtVisionSpec`)
    convnext: Optional[object] = None
    # the statistics the tower was trained on; None: OpenAI CLIP's
    image_mean: Optional[Tuple[float, float, float]] = None
    image_std: Optional[Tuple[float, float, float]] = None
    # the preprocess geometry a hub checkpoint carries (interpolation
    # bicubic | bilinear | nearest, resize_mode shortest | longest |
    # squash); None: bicubic, shortest
    image_interpolation: Optional[str] = None
    image_resize_mode: Optional[str] = None
    # a timm trunk spec (MobileCLIP, EVA, ViTamin, Swin, RelPos-ViT:
    # `models/trunks.py`)
    trunk: Optional[object] = None


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


def _register_resnet_models() -> None:
    """OpenCLIP's `model_configs/RN50*.json` and `RN101.json`: the
    ModifiedResNet towers.  OpenAI's RN checkpoints use QuickGELU: RN50x16
    and RN50x64 are registered with it, the others also as `-quickgelu`
    variants."""
    for name, layers, width, image, embed, t_width, t_heads, t_layers in [
        ("RN50", (3, 4, 6, 3), 64, 224, 1024, 512, 8, 12),
        ("RN101", (3, 4, 23, 3), 64, 224, 512, 512, 8, 12),
        ("RN50x4", (4, 6, 10, 6), 80, 288, 640, 640, 10, 12),
        ("RN50x16", (6, 8, 18, 8), 96, 384, 768, 768, 12, 12),
        ("RN50x64", (3, 15, 36, 10), 128, 448, 1024, 1024, 16, 12),
    ]:
        quick_gelu = name in ("RN50x16", "RN50x64")
        register_model(CLIPConfig(
            name=name, embed_dim=embed, quick_gelu=quick_gelu,
            text=TextConfig(width=t_width, heads=t_heads, layers=t_layers,
                            output_dim=embed),
            vision=VisionConfig(image_size=image, patch_size=32,
                                width=width * 16, layers=sum(layers),
                                output_dim=embed),
            resnet=ResNetVisionSpec(layers=layers, width=width,
                                    image_size=image, output_dim=embed)))
        if not quick_gelu:
            register_model(dataclasses.replace(
                _REGISTRY[name], name=name + "-quickgelu", quick_gelu=True))


def list_models() -> Tuple[str, ...]:
    """All registry names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_model_config(name: str) -> CLIPConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown model '{name}'. Available: {', '.join(list_models())}")
    return _REGISTRY[name]


def register_model(config: CLIPConfig) -> None:
    _REGISTRY[config.name] = config


_register_resnet_models()


def config_from_open_clip_dict(name: str, d: dict) -> CLIPConfig:
    """A CLIPConfig from an OpenCLIP model-config dict (the schema of
    OpenCLIP's `model_configs/*.json` and of a hub checkpoint's
    `open_clip_config.json` `model_cfg`), for the keys of the families
    of the JAX package: a plain ViT, a ModifiedResNet (vision `layers` a
    list), a ConvNeXt, a timm ViT trunk or a timm trunk family
    (MobileCLIP, EVA, ViTamin, Swin, RelPos-ViT), and the native text
    tower or an HF one (`hf_model_name`, with its pooler and head)."""
    v = dict(d.get("vision_cfg", {}))
    t = dict(d.get("text_cfg", {}))
    embed = d["embed_dim"]
    resnet = convnext = trunk = None
    timm_name = v.get("timm_model_name")
    if timm_name:
        from leaf_tpu_torch.models.trunks import spec_for_timm_name
        trunk = spec_for_timm_name(
            timm_name, embed, image_size=v.get("image_size"),
            pool=v.get("timm_pool", "avg"), proj=v.get("timm_proj", "linear"))
    if trunk is not None:
        # a placeholder ViT config that carries image_size and output_dim
        vision = VisionConfig(image_size=trunk.image_size,
                              patch_size=getattr(trunk, "patch_size", 16),
                              width=getattr(trunk, "width", 768),
                              layers=getattr(trunk, "layers", 12),
                              output_dim=embed)
    elif str(timm_name).startswith("convnext"):
        from leaf_tpu_torch.models.convnext import convnext_spec
        convnext = convnext_spec(
            timm_name, embed, image_size=v.get("image_size", 256),
            proj=v.get("timm_proj", "linear") or "none")
        vision = VisionConfig(image_size=convnext.image_size, patch_size=32,
                              width=convnext.dims[-1],
                              layers=sum(convnext.depths), output_dim=embed)
    elif timm_name:
        from leaf_tpu_torch.models.timm_vision import timm_vision_config
        vision = timm_vision_config(
            timm_name, embed, image_size=v.get("image_size"),
            pool=v.get("timm_pool", "avg"), proj=v.get("timm_proj", "linear"))
    elif isinstance(v.get("layers"), (list, tuple)):
        width, image_size = v.get("width", 64), v.get("image_size", 224)
        resnet = ResNetVisionSpec(layers=tuple(v["layers"]), width=width,
                                  image_size=image_size, output_dim=embed)
        vision = VisionConfig(image_size=image_size, patch_size=32,
                              width=width * 16, layers=sum(v["layers"]),
                              output_dim=embed)
    else:
        vision = VisionConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 16),
            width=v.get("width", 768),
            layers=v.get("layers", 12),
            head_width=v.get("head_width", 64),
            mlp_ratio=v.get("mlp_ratio", 4.0),
            output_dim=embed,
            patch_dropout=v.get("patch_dropout", 0.0),
            pool_type={"avg": "avg_patch", "tok": "tok"}.get(
                v.get("pool_type", "tok"), v.get("pool_type", "tok")),
            ln_pre=not v.get("no_ln_pre", False),
            final_ln_after_pool=v.get("final_ln_after_pool", False),
            ln_eps=v.get("norm_kwargs", {}).get("eps", 1e-5),
        )
    text = TextConfig(
        context_length=t.get("context_length", 77),
        vocab_size=t.get("vocab_size", 49408),
        width=t.get("width", 512),
        heads=t.get("heads", 8),
        layers=t.get("layers", 12),
        mlp_ratio=t.get("mlp_ratio", 4.0),
        output_dim=embed,
        pool_type=t.get("pool_type", "argmax"),
        proj_bias=t.get("proj_bias", False),
        no_causal_mask=t.get("no_causal_mask", False),
        pad_id=t.get("pad_id", 0),
        hf_tokenizer_name=t.get("hf_tokenizer_name"),
        tokenizer_kwargs=(tuple(sorted(t["tokenizer_kwargs"].items()))
                          if t.get("tokenizer_kwargs") else None),
        ln_eps=t.get("norm_kwargs", {}).get("eps", 1e-5),
        hf_model_name=t.get("hf_model_name"),
        hf_pooler_type=t.get("hf_pooler_type", "mean_pooler"),
        hf_proj_type=t.get("hf_proj_type", "linear"),
    )
    return CLIPConfig(name=name, embed_dim=embed, text=text, vision=vision,
                      quick_gelu=bool(d.get("quick_gelu", False)),
                      init_logit_scale=d.get("init_logit_scale", 2.6592),
                      init_logit_bias=d.get("init_logit_bias"),
                      resnet=resnet, convnext=convnext, trunk=trunk)


def config_from_hf_dict(name: str, d: dict) -> CLIPConfig:
    """A CLIPConfig from an HF `CLIPConfig` config.json (the schema of
    LEAF's released `LEAF-CLIP/*` repos)."""
    tv = d.get("text_config", {})
    vv = d.get("vision_config", {})
    embed = d.get("projection_dim", 512)
    quick = (tv.get("hidden_act", d.get("hidden_act", "")) == "quick_gelu")
    vision = VisionConfig(
        image_size=vv.get("image_size", 224),
        patch_size=vv.get("patch_size", 16),
        width=vv.get("hidden_size", 768),
        layers=vv.get("num_hidden_layers", 12),
        head_width=(vv.get("hidden_size", 768)
                    // vv.get("num_attention_heads", 12)),
        mlp_ratio=(vv.get("intermediate_size", 3072)
                   / vv.get("hidden_size", 768)),
        output_dim=embed,
    )
    text = TextConfig(
        context_length=tv.get("max_position_embeddings", 77),
        vocab_size=tv.get("vocab_size", 49408),
        width=tv.get("hidden_size", 512),
        heads=tv.get("num_attention_heads", 8),
        layers=tv.get("num_hidden_layers", 12),
        mlp_ratio=(tv.get("intermediate_size", 2048)
                   / tv.get("hidden_size", 512)),
        output_dim=embed,
    )
    return CLIPConfig(name=name, embed_dim=embed, text=text, vision=vision,
                      quick_gelu=quick,
                      init_logit_scale=d.get("logit_scale_init_value", 2.6592))


# -- SigLIP-family models -----------------------------------------------------
# OpenCLIP's `model_configs/ViT-*-SigLIP*.json`: sigmoid loss (logit bias
# -10), a class-token-less timm trunk with the MAP attention pool; text
# without a causal mask, 'last' pool, biased projection, LN eps 1e-6, a
# SentencePiece vocabulary of 32,000 (250,000 for i18n).
def _register_siglip_models() -> None:
    specs = {
        # name: (trunk, embed, image, ctx, vocab, t_width, t_heads,
        #        t_layers, t_mlp_ratio, tokenizer)
        "ViT-B-16-SigLIP": ("vit_base_patch16_siglip_224", 768, 224, 64,
                            32000, 768, 12, 12, 4.0,
                            "timm/ViT-B-16-SigLIP"),
        "ViT-B-16-SigLIP-256": ("vit_base_patch16_siglip_256", 768, 256,
                                64, 32000, 768, 12, 12, 4.0,
                                "timm/ViT-B-16-SigLIP"),
        "ViT-B-16-SigLIP-384": ("vit_base_patch16_siglip_384", 768, 384,
                                64, 32000, 768, 12, 12, 4.0,
                                "timm/ViT-B-16-SigLIP"),
        "ViT-B-16-SigLIP-512": ("vit_base_patch16_siglip_512", 768, 512,
                                64, 32000, 768, 12, 12, 4.0,
                                "timm/ViT-B-16-SigLIP"),
        "ViT-B-16-SigLIP-i18n-256": ("vit_base_patch16_siglip_256", 768,
                                     256, 64, 250000, 768, 12, 12, 4.0,
                                     "timm/ViT-B-16-SigLIP-i18n-256"),
        "ViT-L-16-SigLIP-256": ("vit_large_patch16_siglip_256", 1024,
                                256, 64, 32000, 1024, 16, 24, 4.0,
                                "timm/ViT-B-16-SigLIP"),
        "ViT-L-16-SigLIP-384": ("vit_large_patch16_siglip_384", 1024,
                                384, 64, 32000, 1024, 16, 24, 4.0,
                                "timm/ViT-B-16-SigLIP"),
        "ViT-SO400M-14-SigLIP": ("vit_so400m_patch14_siglip_224", 1152,
                                 224, 16, 32000, 1152, 16, 27, 3.7362,
                                 "timm/ViT-B-16-SigLIP"),
        "ViT-SO400M-14-SigLIP-384": ("vit_so400m_patch14_siglip_384",
                                     1152, 384, 64, 32000, 1152, 16, 27,
                                     3.7362, "timm/ViT-B-16-SigLIP"),
    }
    for name, (trunk, embed, image, ctx, vocab, tw, th, tl, tmr,
               tok) in specs.items():
        cfg = config_from_open_clip_dict(name, {
            "embed_dim": embed,
            "init_logit_bias": -10,
            "vision_cfg": {"image_size": image, "timm_model_name": trunk,
                           "timm_pool": "map", "timm_proj": "none"},
            "text_cfg": {"context_length": ctx, "vocab_size": vocab,
                         "hf_tokenizer_name": tok,
                         "tokenizer_kwargs": {"clean": "canonicalize"},
                         "width": tw, "heads": th, "layers": tl,
                         "mlp_ratio": tmr, "no_causal_mask": True,
                         "proj_bias": True, "pool_type": "last",
                         "norm_kwargs": {"eps": 1e-6}},
        })
        # SigLIP towers train on mean = std = (0.5, 0.5, 0.5)
        register_model(dataclasses.replace(
            cfg, image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5)))
    # test-size SigLIP-style model
    register_model(CLIPConfig(
        name="siglip-tiny-test", embed_dim=64,
        init_logit_scale=1.0, init_logit_bias=-10.0,
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64,
                        no_causal_mask=True, proj_bias=True,
                        pool_type="last", ln_eps=1e-6),
        vision=VisionConfig(image_size=64, patch_size=16, width=64,
                            layers=2, head_width=32, output_dim=64,
                            patch_bias=True, ln_pre=False,
                            cls_token=False, attn_pool=True,
                            ln_eps=1e-6)))


_register_siglip_models()


# -- CLIPA-family models ------------------------------------------------------
# OpenCLIP's `model_configs/ViT-{L,H,bigG}-14-CLIPA*.json`: no ln_pre, 'avg'
# pooling with ln_post after the pool; text without a causal mask,
# 'last'-pooled, a BERT-uncased vocabulary of 32,000.
def _register_clipa_models() -> None:
    specs = {
        # name: (embed, v_layers, v_width, v_head_width, image, t_width,
        #        t_heads, t_layers, ctx)
        "ViT-L-14-CLIPA": (768, 24, 1024, 64, 224, 768, 12, 12, 32),
        "ViT-L-14-CLIPA-336": (768, 24, 1024, 64, 336, 768, 12, 12, 32),
        "ViT-H-14-CLIPA": (1024, 32, 1280, 80, 224, 1024, 16, 24, 32),
        "ViT-H-14-CLIPA-336": (1024, 32, 1280, 80, 336, 1024, 16, 24, 32),
        "ViT-bigG-14-CLIPA": (1280, 48, 1664, 104, 224, 1280, 20, 32, 32),
        "ViT-bigG-14-CLIPA-336": (1280, 48, 1664, 104, 336, 1280, 20, 32,
                                  32),
    }
    for name, (embed, vl, vw, vhw, image, tw, th, tl, ctx) in \
            specs.items():
        mlp = 4.9231 if "bigG" in name else 4.0
        register_model(config_from_open_clip_dict(name, {
            "embed_dim": embed,
            "vision_cfg": {"image_size": image, "layers": vl, "width": vw,
                           "head_width": vhw, "mlp_ratio": mlp,
                           "patch_size": 14, "no_ln_pre": True,
                           "pool_type": "avg",
                           "final_ln_after_pool": True},
            "text_cfg": {"context_length": ctx, "vocab_size": 32000,
                         "hf_tokenizer_name": "bert-base-uncased",
                         "tokenizer_kwargs": {"strip_sep_token": True},
                         "width": tw, "heads": th, "layers": tl,
                         "pool_type": "last", "no_causal_mask": True},
        }))


_register_clipa_models()


# -- the other plain ViT sizes of OpenCLIP's model_configs --------------------
def _register_vit_variants() -> None:
    for c in [
        _cfg("ViT-S-16", 384, v_layers=12, v_width=384, v_patch=16,
             t_width=384, t_heads=6, t_layers=12),
        _cfg("ViT-S-16-alt", 256, v_layers=12, v_width=384, v_patch=16,
             t_width=256, t_heads=4, t_layers=10),
        _cfg("ViT-S-32-alt", 256, v_layers=12, v_width=384, v_patch=32,
             t_width=256, t_heads=4, t_layers=10),
        _cfg("ViT-M-16", 512, v_layers=12, v_width=512, v_patch=16,
             t_width=512, t_heads=8, t_layers=12),
        _cfg("ViT-M-16-alt", 384, v_layers=12, v_width=512, v_patch=16,
             t_width=384, t_heads=6, t_layers=12),
        _cfg("ViT-M-32", 512, v_layers=12, v_width=512, v_patch=32,
             t_width=512, t_heads=8, t_layers=12),
        _cfg("ViT-M-32-alt", 384, v_layers=12, v_width=512, v_patch=32,
             t_width=384, t_heads=6, t_layers=12),
        _cfg("ViT-B-16-plus", 640, v_layers=12, v_width=896, v_patch=16,
             t_width=640, t_heads=10, t_layers=12),
        _cfg("ViT-B-16-plus-240", 640, v_layers=12, v_width=896,
             v_patch=16, t_width=640, t_heads=10, t_layers=12,
             image_size=240),
        _cfg("ViT-B-32-256", 512, v_layers=12, v_width=768, v_patch=32,
             t_width=512, t_heads=8, t_layers=12, image_size=256),
        _cfg("ViT-B-32-plus-256", 640, v_layers=12, v_width=896,
             v_patch=32, t_width=640, t_heads=10, t_layers=12,
             image_size=256),
        _cfg("ViT-L-16", 768, v_layers=24, v_width=1024, v_patch=16,
             t_width=768, t_heads=12, t_layers=12),
        _cfg("ViT-L-16-320", 768, v_layers=24, v_width=1024, v_patch=16,
             t_width=768, t_heads=12, t_layers=12, image_size=320),
        _cfg("ViT-L-14-280", 768, v_layers=24, v_width=1024, v_patch=14,
             t_width=768, t_heads=12, t_layers=12, image_size=280),
        _cfg("ViT-H-16", 1024, v_layers=32, v_width=1280, v_patch=16,
             t_width=1024, t_heads=16, t_layers=24, v_head_width=80),
        _cfg("ViT-H-14-378-quickgelu", 1024, v_layers=32, v_width=1280,
             v_patch=14, t_width=1024, t_heads=16, t_layers=24,
             v_head_width=80, image_size=378, quick_gelu=True),
        # PaLI's 4B-parameter "e" tower
        _cfg("ViT-e-14", 1280, v_layers=56, v_width=1792, v_patch=14,
             t_width=1280, t_heads=20, t_layers=36, v_head_width=112,
             v_mlp_ratio=8.5715),
    ]:
        register_model(c)
    # quickgelu aliases of the MetaCLIP and DFN tags
    for base in ["ViT-H-14", "ViT-bigG-14"]:
        register_model(dataclasses.replace(
            _REGISTRY[base], name=base + "-quickgelu", quick_gelu=True))


_register_vit_variants()

# OpenCLIP's `vit_medium_patch16_gap_256.json`: the timm gap-ViT trunk (no
# class token, mean over all tokens)
register_model(config_from_open_clip_dict("vit_medium_patch16_gap_256", {
    "embed_dim": 512,
    "vision_cfg": {"timm_model_name": "vit_medium_patch16_gap_256",
                   "timm_pool": "", "timm_proj": "linear",
                   "image_size": 256},
    "text_cfg": {"context_length": 77, "vocab_size": 49408,
                 "width": 512, "heads": 8, "layers": 12},
}))


def _register_mobileclip_models() -> None:
    """OpenCLIP's `model_configs/MobileCLIP-{B,S1,S2}.json`: MCi hybrid-ViT
    and FastViT trunks whose classifier is the projection; the S1/S2 text
    towers have no causal mask.  MobileCLIP trains without input
    normalization: mean (0, 0, 0), std (1, 1, 1)."""
    def register_mc(cfg):
        register_model(dataclasses.replace(
            cfg, image_mean=(0.0, 0.0, 0.0), image_std=(1.0, 1.0, 1.0)))

    register_mc(config_from_open_clip_dict("MobileCLIP-B", {
        "embed_dim": 512,
        "vision_cfg": {"timm_model_name": "vit_base_mci_224",
                       "timm_pool": "token", "timm_proj": None,
                       "image_size": 224},
        "text_cfg": {"context_length": 77, "vocab_size": 49408,
                     "width": 512, "heads": 8, "layers": 12,
                     "no_causal_mask": False},
    }))
    for name, trunk in (("MobileCLIP-S1", "fastvit_mci1"),
                        ("MobileCLIP-S2", "fastvit_mci2")):
        register_mc(config_from_open_clip_dict(name, {
            "embed_dim": 512,
            "vision_cfg": {"timm_model_name": trunk, "timm_pool": "avg",
                           "timm_proj": None, "image_size": 256},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": 512, "heads": 8, "layers": 12,
                         "no_causal_mask": True},
        }))
    # test-size variants
    from leaf_tpu_torch.models.mci import FastVitSpec, MciViTSpec
    register_model(CLIPConfig(
        name="mci-vit-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64),
        vision=VisionConfig(image_size=32, patch_size=16, width=32,
                            layers=2, output_dim=64),
        trunk=MciViTSpec(name="mci-vit-tiny", image_size=32, width=32,
                         layers=2, heads=2, stem_channels=(8, 8, 32),
                         stem_kernels=(4, 2, 2), output_dim=64)))
    register_model(CLIPConfig(
        name="fastvit-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64),
        vision=VisionConfig(image_size=32, patch_size=4, width=8,
                            layers=4, output_dim=64),
        trunk=FastVitSpec(name="fastvit-tiny", image_size=32,
                          dims=(8, 16, 32, 64), depths=(1, 2, 2, 1),
                          mlp_ratio=2.0, attn_head_dim=8,
                          output_dim=64)))


_register_mobileclip_models()


def _register_convnext_models() -> None:
    """OpenCLIP's `model_configs/convnext_*.json`: timm ConvNeXt trunks
    with the trunk's own average pool and head norm (`timm_pool: ""`) and
    OpenCLIP's linear or MLP projection head."""
    for name, trunk, embed, image, proj, tw, th, tl in [
        ("convnext_base", "convnext_base", 512, 224, "linear", 512, 8, 12),
        ("convnext_base_w", "convnext_base", 640, 256, "linear", 640, 10, 12),
        ("convnext_base_w_320", "convnext_base", 640, 320, "linear", 640, 10,
         12),
        ("convnext_large_d", "convnext_large", 768, 256, "mlp", 768, 12, 16),
        ("convnext_large_d_320", "convnext_large", 768, 320, "mlp", 768, 12,
         16),
        ("convnext_xxlarge", "convnext_xxlarge", 1024, 256, "linear", 1024,
         16, 24),
        ("convnext_tiny", "convnext_tiny", 1024, 224, "linear", 512, 8, 12),
        ("convnext_small", "convnext_small", 512, 224, "linear", 512, 8, 12),
        ("convnext_large", "convnext_large", 768, 224, "linear", 768, 12, 12),
        ("convnext_xlarge", "convnext_xlarge", 1024, 256, "linear", 1024, 16,
         20),
        ("convnext_xxlarge_320", "convnext_xxlarge", 1024, 320, "linear",
         1024, 16, 24),
    ]:
        register_model(config_from_open_clip_dict(name, {
            "embed_dim": embed,
            "vision_cfg": {"timm_model_name": trunk, "timm_pool": "",
                           "timm_proj": proj, "image_size": image},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": tw, "heads": th, "layers": tl},
        }))
    # test-size variant
    from leaf_tpu_torch.models.convnext import ConvNeXtVisionSpec
    register_model(CLIPConfig(
        name="convnext-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, width=64, heads=2, layers=2,
                        output_dim=64),
        vision=VisionConfig(image_size=64, patch_size=32, width=128,
                            layers=5, output_dim=64),
        convnext=ConvNeXtVisionSpec(depths=(1, 1, 2, 1),
                                    dims=(16, 32, 64, 128), image_size=64,
                                    output_dim=64, proj="linear")))


_register_convnext_models()


def _register_eva_models() -> None:
    """OpenCLIP's `model_configs/EVA01-g-14*.json` and `EVA02-*.json`: timm
    EVA trunks, token pool, the trunk's classifier as the projection
    (`timm_proj: null`), the native CLIP text tower."""
    for name, trunk, embed, image, tw, th, tl in [
        ("EVA01-g-14", "eva_giant_patch14_224", 1024, 224, 768, 12, 12),
        ("EVA01-g-14-plus", "eva_giant_patch14_224", 1024, 224, 1024, 16,
         24),
        ("EVA02-B-16", "eva02_base_patch16_clip_224", 512, 224, 512, 8, 12),
        ("EVA02-L-14", "eva02_large_patch14_clip_224", 768, 224, 768, 12,
         12),
        ("EVA02-L-14-336", "eva02_large_patch14_clip_336", 768, 336, 768, 12,
         12),
        ("EVA02-E-14", "eva02_enormous_patch14_clip_224", 1024, 224, 1024,
         16, 24),
        ("EVA02-E-14-plus", "eva02_enormous_patch14_clip_224", 1024, 224,
         1280, 20, 32),
    ]:
        register_model(config_from_open_clip_dict(name, {
            "embed_dim": embed,
            "vision_cfg": {"timm_model_name": trunk, "timm_pool": "token",
                           "timm_proj": None, "image_size": image},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": tw, "heads": th, "layers": tl},
        }))
    # test-size EVA02-style variant: rope, SwiGLU and the sub-LNs
    from leaf_tpu_torch.models.eva import EvaVisionSpec
    register_model(CLIPConfig(
        name="eva-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64),
        vision=VisionConfig(image_size=32, patch_size=8, width=64,
                            layers=2, output_dim=64),
        trunk=EvaVisionSpec(name="eva-tiny", image_size=32, patch_size=8,
                            width=64, layers=2, heads=2, mlp_hidden=128,
                            output_dim=64, swiglu=True, rope=True,
                            inner_attn_ln=True, mlp_ln=True,
                            fused_qkv=False, ref_feat_size=4)))


_register_eva_models()


def _register_relpos_swin_models() -> None:
    """OpenCLIP's `model_configs/swin_base_patch4_window7_224.json` and
    `vit_relpos_medium_patch16_cls_224.json`: the two timm-trunk
    singletons, with the native CLIP text tower."""
    register_model(config_from_open_clip_dict(
        "swin_base_patch4_window7_224", {
            "embed_dim": 640,
            "vision_cfg": {"timm_model_name": "swin_base_patch4_window7_224",
                           "timm_pool": "", "timm_proj": "linear",
                           "image_size": 224},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": 640, "heads": 10, "layers": 12},
        }))
    register_model(config_from_open_clip_dict(
        "vit_relpos_medium_patch16_cls_224", {
            "embed_dim": 512,
            "vision_cfg": {
                "timm_model_name": "vit_relpos_medium_patch16_cls_224",
                "timm_pool": "", "timm_proj": "linear", "image_size": 224},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": 512, "heads": 8, "layers": 12},
        }))
    # test-size variants
    from leaf_tpu_torch.models.relpos_vit import RelPosViTSpec
    from leaf_tpu_torch.models.swin import SwinVisionSpec
    register_model(CLIPConfig(
        name="swin-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64),
        vision=VisionConfig(image_size=32, patch_size=4, width=16,
                            layers=4, output_dim=64),
        trunk=SwinVisionSpec(name="swin-tiny", image_size=32, patch_size=4,
                             embed_dim=16, depths=(2, 2), heads=(2, 4),
                             window=4, output_dim=64)))
    register_model(CLIPConfig(
        name="relpos-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64),
        vision=VisionConfig(image_size=32, patch_size=8, width=64,
                            layers=2, output_dim=64),
        trunk=RelPosViTSpec(name="relpos-tiny", image_size=32, patch_size=8,
                            width=64, layers=2, heads=2, rel_pos_dim=16,
                            output_dim=64)))


_register_relpos_swin_models()


def _register_vitamin_models() -> None:
    """OpenCLIP's `model_configs/ViTamin-*.json`: timm ViTamin trunks with
    their own average pool and `fc_norm` (`timm_pool: ""`) and OpenCLIP's
    linear projection head."""
    for name, trunk, embed, image, tw, th, tl in [
        ("ViTamin-S", "vitamin_small_224", 384, 224, 384, 6, 12),
        ("ViTamin-S-LTT", "vitamin_small_224", 768, 224, 768, 12, 12),
        ("ViTamin-B", "vitamin_base_224", 512, 224, 512, 8, 12),
        ("ViTamin-B-LTT", "vitamin_base_224", 768, 224, 768, 12, 12),
        ("ViTamin-L", "vitamin_large_224", 768, 224, 768, 12, 12),
        ("ViTamin-L-256", "vitamin_large_256", 768, 256, 768, 12, 12),
        ("ViTamin-L-336", "vitamin_large_336", 768, 336, 768, 12, 12),
        ("ViTamin-L2", "vitamin_large2_224", 1024, 224, 1024, 16, 24),
        ("ViTamin-L2-256", "vitamin_large2_256", 1024, 256, 1024, 16, 24),
        ("ViTamin-L2-336", "vitamin_large2_336", 1024, 336, 1024, 16, 24),
        ("ViTamin-XL-256", "vitamin_xlarge_256", 1152, 256, 1152, 16, 27),
        ("ViTamin-XL-336", "vitamin_xlarge_336", 1152, 336, 1152, 16, 27),
        # OpenCLIP's config has image_size 256 though its trunk name says
        # 384; the config's size wins, as in OpenCLIP's TimmModel
        ("ViTamin-XL-384", "vitamin_xlarge_384", 1152, 256, 1152, 16, 27),
    ]:
        register_model(config_from_open_clip_dict(name, {
            "embed_dim": embed,
            "vision_cfg": {"timm_model_name": trunk, "timm_pool": "",
                           "timm_proj": "linear", "image_size": image},
            "text_cfg": {"context_length": 77, "vocab_size": 49408,
                         "width": tw, "heads": th, "layers": tl},
        }))
    # test-size variant
    from leaf_tpu_torch.models.vitamin import ViTaminVisionSpec
    register_model(CLIPConfig(
        name="vitamin-tiny-test", embed_dim=64,
        text=TextConfig(context_length=16, vocab_size=512, width=64,
                        heads=2, layers=2, output_dim=64),
        vision=VisionConfig(image_size=32, patch_size=16, width=32,
                            layers=2, output_dim=64),
        trunk=ViTaminVisionSpec(name="vitamin-tiny", image_size=32,
                                dims=(8, 16, 32), depths=(1, 2),
                                vit_depth=2, heads=2, output_dim=64)))


_register_vitamin_models()


def _register_hf_text_models() -> None:
    """OpenCLIP's `model_configs/{roberta,xlm-roberta,mt5,nllb-clip}-*.json`:
    an HF text tower (`models/hf_text.py`: the encoder, its pooler and a
    bias-free projection) beside a ViT or SigLIP vision tower."""
    vit_b_32 = {"image_size": 224, "layers": 12, "width": 768,
                "patch_size": 32}
    vit_h_14 = {"image_size": 224, "layers": 32, "width": 1280,
                "head_width": 80, "patch_size": 14}
    specs = {
        # name: (embed, vision dict, hf_model, pooler, proj, quick_gelu)
        "roberta-ViT-B-32": (512, vit_b_32, "roberta-base", "mean_pooler",
                             "linear", True),
        "xlm-roberta-base-ViT-B-32": (512, vit_b_32, "xlm-roberta-base",
                                      "mean_pooler", "linear", False),
        "xlm-roberta-large-ViT-H-14": (1024, vit_h_14, "xlm-roberta-large",
                                       "mean_pooler", "linear", False),
        "mt5-base-ViT-B-32": (512, vit_b_32, "google/mt5-base",
                              "mean_pooler", "linear", False),
        "mt5-xl-ViT-H-14": (1024, vit_h_14, "google/mt5-xl", "mean_pooler",
                            "linear", False),
        "nllb-clip-base": (512, vit_b_32, "facebook/nllb-200-distilled-600M",
                           "cls_pooler", "linear", False),
        "nllb-clip-large": (1024, vit_h_14,
                            "facebook/nllb-200-distilled-1.3B", "cls_pooler",
                            "linear", False),
        "nllb-clip-base-siglip": (
            768, {"image_size": 384,
                  "timm_model_name": "vit_base_patch16_siglip_384",
                  "timm_pool": "map", "timm_proj": "none"},
            "facebook/nllb-200-distilled-600M", "cls_pooler", "linear",
            False),
        "nllb-clip-large-siglip": (
            1152, {"image_size": 384,
                   "timm_model_name": "vit_so400m_patch14_siglip_384",
                   "timm_pool": "map", "timm_proj": "none"},
            "facebook/nllb-200-distilled-1.3B", "cls_pooler", "linear",
            False),
    }
    for name, (embed, vision, hf, pooler, proj, qg) in specs.items():
        d = {"embed_dim": embed, "quick_gelu": qg, "vision_cfg": vision,
             "text_cfg": {"hf_model_name": hf, "hf_tokenizer_name": hf,
                          "hf_pooler_type": pooler, "hf_proj_type": proj}}
        if "siglip" in name:
            d["init_logit_bias"] = -10
        cfg = config_from_open_clip_dict(name, d)
        if "siglip" in name:
            cfg = dataclasses.replace(cfg, image_mean=(0.5, 0.5, 0.5),
                                      image_std=(0.5, 0.5, 0.5))
        register_model(cfg)


_register_hf_text_models()
