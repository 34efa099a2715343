"""Model factory: name -> model, transforms and tokenizer (port of
`leaf_tpu/models/factory.py`): every registry name of the JAX package, CoCa
included, `hf-hub:` model names from a local snapshot, registry tags
(`models/pretrained.py`) from the local checkpoint cache, and the
overrides (`force_quick_gelu`, `force_patch_dropout`, `force_image_size`,
the transforms' `image_mean/std/interpolation/resize_mode`).

Weights are made on the CPU, from the given checkpoint or from a seeded
`torch.Generator` with the JAX package's init distributions, then moved
to the requested device, so a CPU copy and a CUDA copy of one seed hold
identical weights.  Precision then casts the matrix weights and
embeddings to the working dtype once; LayerNorm and BatchNorm parameters
(and the logit scale) stay fp32, as the JAX package casts at each use.
That one rounding is right for serving and wrong for an optimizer whose
updates are smaller than a bf16 step: with `master_weights` the text tower
keeps its fp32 weights and casts them where it uses them.  An HF text
tower (CustomTextCLIP configs, `coca_roberta-*`) stays fp32 whatever the
precision, as the JAX package builds it without a dtype.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch.models import coca, interop
from leaf_tpu_torch.models.clip import CLIP
from leaf_tpu_torch.models.config import CLIPConfig, get_model_config
from leaf_tpu_torch.models.hf_text import HFTextTower
from leaf_tpu_torch.models.layers import LayerNorm
from leaf_tpu_torch.models.preprocess import (image_transform,
                                              train_image_transform)
from leaf_tpu_torch.models.resnet import BatchNorm
from leaf_tpu_torch.parallel.distributed import rank
from leaf_tpu_torch.tokenizer import get_tokenizer as _get_bpe

PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}
LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class CLIPModel:
    """A CLIP module on its device, with entry points that take host
    arrays (numpy or tensors) and return device tensors."""
    cfg: CLIPConfig
    module: CLIP
    dtype: torch.dtype
    device: torch.device

    def encode_text(self, tokens, normalize: bool = False) -> torch.Tensor:
        return self.module.encode_text(
            torch.as_tensor(np.asarray(tokens), device=self.device), normalize)

    def encode_image(self, images, normalize: bool = False) -> torch.Tensor:
        return self.module.encode_image(
            torch.as_tensor(np.asarray(images), device=self.device), normalize)


@dataclasses.dataclass
class CoCaModel:
    """A CoCa module on its device, computing in `dtype` on fp32 weights
    (the JAX package's CoCa bundle), with entry points that take host
    arrays and return device tensors."""
    cfg: coca.CoCaConfig
    module: coca.CoCa
    dtype: torch.dtype
    device: torch.device

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device)

    def encode_image(self, images, normalize: bool = True) -> torch.Tensor:
        return self.module.encode_image(self._on(images), normalize)[0]

    def encode_text(self, tokens, normalize: bool = True) -> torch.Tensor:
        return self.module.encode_text(self._on(tokens), normalize)[0]

    def forward(self, images, tokens) -> dict:
        return self.module(self._on(images), self._on(tokens))

    def generate(self, images, generator: Optional[torch.Generator] = None,
                 generation_type: str = "beam_search", **kw) -> torch.Tensor:
        """Captions as token ids: "beam_search" (the default, OpenCLIP's)
        runs the group beam search (deterministic: `generator`, `top_k`
        and `top_p` are ignored); "top_k" and "top_p" the sampling loop,
        `top_p` defaulting to 0.1 for "top_p"."""
        images = self._on(images)
        if generation_type == "beam_search":
            kw.pop("top_k", None)
            kw.pop("top_p", None)
            return coca.generate_beamsearch(self.module, images, **kw)
        if generation_type not in ("top_k", "top_p"):
            raise ValueError(
                f"generation_type must be top_k | top_p | beam_search, "
                f"got {generation_type!r}")
        if generation_type == "top_p":
            kw.setdefault("top_p", 0.1)
        return coca.generate(self.module, images, generator, **kw)


def _cast_weights(module: torch.nn.Module, dtype: torch.dtype) -> None:
    """Matrix weights, biases and embeddings of `module` and its
    submodules to `dtype`; LayerNorm and BatchNorm parameters, the
    CLIP-level scalars and an HF text tower stay fp32."""
    skip = {id(p) for m in module.modules() if isinstance(m, HFTextTower)
            for p in m.parameters()}
    for m in module.modules():
        if isinstance(m, (LayerNorm, BatchNorm, CLIP)):
            continue
        for p in m.parameters(recurse=False):
            if id(p) not in skip:
                p.data = p.data.to(dtype)


def local_checkpoint(path: Optional[str], flag: str = "--pretrained",
                     model_name: Optional[str] = None) -> Optional[str]:
    """`path` when it is None or names a local checkpoint file or
    directory; a registry tag of `model_name` or an `hf-hub:` id resolves
    to its file in the local checkpoint cache
    (`pretrained.resolve_pretrained`), which raises where the cache lacks
    it.  Any other name raises."""
    if not path or os.path.exists(path):
        return path or None
    from leaf_tpu_torch.models import pretrained as reg
    if path.startswith("hf-hub:") or (
            model_name and reg.get_pretrained_cfg(model_name, path)):
        return reg.resolve_pretrained(model_name or "", path)
    raise FileNotFoundError(
        f"{flag} {path!r}: neither a local checkpoint nor a registry tag of "
        f"{model_name!r} (models/pretrained.py: list_pretrained())")


TRAINERS = ("leaf", "contrastive", "fare")


def require_trainable(model_name: str, trainer: str) -> None:
    """Refuse, before it builds the model, what the JAX package's trainer
    of the same kind cannot train either; each trainer takes what its JAX
    trainer takes, and no more (ROADMAP Queue 1 item 11 step 4):

    - "leaf" (`train.driver`): every model with a native text tower.  The
      JAX driver has no family check: it locks the vision tower
      (`leaf_tpu/train/driver.py:132-137`) and trains the text tower
      through `clip.encode_text` (`leaf_tpu/train/fused.py:79-90,
      146-150`); the vision tower runs only in the in-training evals,
      whose PGD takes the input's gradient through `encode_image_model`
      (`leaf_tpu/attacks/image.py:43-46`), which takes every family.
    - "contrastive" (`train.contrastive_driver`): every vision family,
      since JAX's step runs `clip.forward` -> `encode_image_model`
      (`leaf_tpu/train/contrastive.py:33-59`, `leaf_tpu/models/clip.py:
      228-254, 463-479`), and every CoCa model, `coca_roberta-*` with its
      HF text tower included, through the CoCa step.
    - "fare" (`train.fare_driver`): the ViT family only (plain ViT,
      SigLIP's MAP head, CLIPA, timm heads and patch biases):
      `fare.encode_vision` runs `clip.encode_image` on `cfg.vision`
      (`leaf_tpu/train/fare.py:40-47`), which has no ModifiedResNet,
      ConvNeXt or trunk path.

    A CustomTextCLIP model (an HF text tower) trains in none of them:
    `clip.forward` and the fused LEAF step call the native `encode_text`
    on its HF tree.  What is refused raises "in the JAX package as
    here"."""
    if trainer not in TRAINERS:
        raise ValueError(f"trainer must be one of {TRAINERS}, got "
                         f"{trainer!r}")
    if model_name in coca.COCA_CONFIGS:
        what = ("an HF text tower" if trainer != "contrastive"
                and coca.get_coca_config(model_name).hf_text_name else None)
    else:
        cfg = get_model_config(model_name)
        what = ("an HF text tower" if cfg.text.hf_model_name else
                None if trainer != "fare" else
                "a ModifiedResNet tower" if cfg.resnet is not None else
                "a ConvNeXt tower" if cfg.convnext is not None else
                f"a {type(cfg.trunk).__name__} trunk"
                if cfg.trunk is not None else None)
    if what is not None:
        raise NotImplementedError(
            f"{model_name} ({what}) has no path in the {trainer} trainer, "
            "in the JAX package as here")


def _adopt_activation(cfg: CLIPConfig, model_name: str, pretrained: str,
                      force_quick_gelu: bool) -> CLIPConfig:
    """The activation the checkpoint declares (`interop.
    checkpoint_quick_gelu`; for a registry tag whose file carries none,
    the registry entry's `quick_gelu`) wins over the config's, unless
    QuickGELU was forced; either way a disagreement is logged."""
    ckpt_qg = interop.checkpoint_quick_gelu(pretrained)
    if ckpt_qg is None:
        from leaf_tpu_torch.models.pretrained import get_pretrained_cfg
        ckpt_qg = get_pretrained_cfg(model_name, pretrained).get("quick_gelu")
    if ckpt_qg is None or ckpt_qg == cfg.quick_gelu:
        return cfg
    if force_quick_gelu:
        LOG.warning("%s: checkpoint %s declares hidden_act=%s but "
                    "quick_gelu was forced on — keeping QuickGELU",
                    model_name, pretrained,
                    "quick_gelu" if ckpt_qg else "gelu")
        return cfg
    LOG.warning("%s: adopting %s activation from checkpoint %s "
                "(config said %s; reference resolves the config from the "
                "checkpoint, factory.py:200-207)", model_name,
                "quick_gelu" if ckpt_qg else "gelu", pretrained,
                "quick_gelu" if cfg.quick_gelu else "gelu")
    return dataclasses.replace(cfg, quick_gelu=ckpt_qg)


def _config_from_hub(model_name: str, config_only: bool = False
                     ) -> Tuple[CLIPConfig, str]:
    """An `hf-hub:org/repo` model name -> (config, local snapshot
    directory): `open_clip_config.json` (with its `preprocess_cfg`'s
    statistics and geometry) or an HF `config.json`, from the snapshot
    `pretrained.download_pretrained_from_hf` finds in the local cache."""
    import json

    from leaf_tpu_torch.models.config import (config_from_hf_dict,
                                              config_from_open_clip_dict)
    from leaf_tpu_torch.models.pretrained import download_pretrained_from_hf
    snapshot = download_pretrained_from_hf(model_name,
                                           config_only=config_only)
    oc = os.path.join(snapshot, "open_clip_config.json")
    hf = os.path.join(snapshot, "config.json")
    if os.path.exists(oc):
        with open(oc) as f:
            d = json.load(f)
        cfg = config_from_open_clip_dict(model_name, d.get("model_cfg", d))
        pc = d.get("preprocess_cfg") or {}
        if pc:
            cfg = dataclasses.replace(
                cfg,
                image_mean=(tuple(pc["mean"]) if pc.get("mean")
                            else cfg.image_mean),
                image_std=(tuple(pc["std"]) if pc.get("std")
                           else cfg.image_std),
                image_interpolation=pc.get("interpolation",
                                           cfg.image_interpolation),
                image_resize_mode=pc.get("resize_mode",
                                         cfg.image_resize_mode))
    elif os.path.exists(hf):
        with open(hf) as f:
            cfg = config_from_hf_dict(model_name, json.load(f))
    else:
        raise FileNotFoundError(
            f"{model_name}: snapshot {snapshot} has neither "
            "open_clip_config.json nor config.json")
    return cfg, snapshot


def _override(cfg: CLIPConfig, force_quick_gelu: bool,
              force_patch_dropout: Optional[float],
              force_image_size: Optional[int]) -> CLIPConfig:
    """The JAX package's config overrides: QuickGELU, the train-time patch
    dropout, and the vision resolution (ViT towers only; a checkpoint's
    position grid is then resized on load)."""
    if force_quick_gelu:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
    if force_patch_dropout is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, patch_dropout=force_patch_dropout))
    if force_image_size is not None:
        if cfg.trunk is not None or cfg.convnext is not None \
                or cfg.resnet is not None:
            raise ValueError(
                "--force-image-size is implemented for ViT towers (the "
                "position-grid resize handles the ViT grid only)")
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, image_size=force_image_size))
    return cfg


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "fp32", seed: int = 0, *,
                 device, master_weights: bool = False,
                 force_patch_dropout: Optional[float] = None,
                 force_quick_gelu: bool = False,
                 force_image_size: Optional[int] = None,
                 int8_mlp: bool = False):
    """Build a CLIP model by registry name (or an `hf-hub:org/repo` name,
    its config and weights from the local snapshot) on `device` ('cuda',
    'cpu', ...).  `pretrained` is a local HF or OpenCLIP checkpoint file or
    snapshot directory, an `hf-hub:` id or a registry tag of the model,
    both found in the local checkpoint cache (`models/pretrained.py`);
    without it the weights are a seeded random init.  A checkpoint's
    declared activation (its `open_clip_config.json` or HF `config.json`,
    else the registry entry's) is adopted unless `force_quick_gelu`, and
    its vision position grid is resized to the config's resolution
    (`force_image_size` sets that resolution for a ViT tower).

    `master_weights` is the JAX package's precision policy, for the
    trainer and the evals: the text tower's weights stay fp32 and it
    computes in `precision` (`TextTower.compute_dtype`); the vision tower
    stays fp32 and computes in fp32, since the evals encode images (and
    run PGD) in fp32, as the JAX package's do; a trainer of the vision
    tower sets its `compute_dtype`.  `force_patch_dropout` sets the vision
    config's train-time `patch_dropout`.  `int8_mlp` stores every MLP
    weight as int8 with per-column scales (`models.quantize`), quantized
    from the fp32 weights before the cast to `precision`.

    A config with `resnet`, `convnext` or a `trunk` (MobileCLIP, EVA,
    ViTamin, Swin, RelPos-ViT) builds that vision tower (`clip.CLIP`); one
    with `init_logit_bias` (SigLIP) has a `logit_bias`; one with an HF text
    tower (`text.hf_model_name`: the CustomTextCLIP configs) builds
    `hf_text.HFTextTower`, fp32, from the seeded init (a unified
    checkpoint for it raises `ValueError`, as in the JAX package).

    A CoCa name (`coca.COCA_CONFIGS`) gives a `CoCaModel`: fp32 weights
    that compute in `precision`, from `pretrained` (an OpenCLIP CoCa file)
    or the seeded init; the CLIP-only options do not apply to it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    if model_name in coca.COCA_CONFIGS:
        if force_image_size is not None:
            raise ValueError(
                "--force-image-size is not implemented for CoCa models")
        module = coca.create_coca_model(
            model_name, local_checkpoint(pretrained, model_name=model_name),
            seed, device=device)
        module.set_compute_dtype(PRECISIONS[precision])
        return CoCaModel(cfg=module.cfg, module=module,
                         dtype=PRECISIONS[precision], device=device)
    if model_name.startswith("hf-hub:"):
        # an explicit `pretrained` needs the snapshot's config alone
        cfg, snapshot = _config_from_hub(model_name,
                                         config_only=bool(pretrained))
        pretrained = pretrained or snapshot
    else:
        cfg = get_model_config(model_name)
    cfg = _override(cfg, force_quick_gelu, force_patch_dropout,
                    force_image_size)
    if cfg.text.hf_model_name and pretrained:
        raise ValueError(
            f"{model_name}: loading a unified checkpoint into an "
            "HF-text-tower model is not supported; load the HF tower from "
            "a local HF directory (hf_text.HFTextTower(path, "
            "pretrained=True)) and the vision tower separately")
    if pretrained:
        cfg = _adopt_activation(cfg, model_name, pretrained, force_quick_gelu)
        pretrained = local_checkpoint(pretrained, model_name=model_name)
        module = CLIP(cfg)
        module.load_state_dict(interop.resize_vision_pos_embed(
            interop.load_pretrained(pretrained, cfg), cfg))
    else:
        module = CLIP(cfg)
        module.init_weights(torch.Generator().manual_seed(seed))
    if int8_mlp:
        from leaf_tpu_torch.models.quantize import quantize_mlp_params
        quantize_mlp_params(module)
    module.to(device)
    dtype = PRECISIONS[precision]
    if master_weights:
        module.text.compute_dtype = dtype
    else:
        _cast_weights(module, dtype)
    module.eval()
    return CLIPModel(cfg=cfg, module=module, dtype=dtype, device=device)


def create_model_and_transforms(
        model_name: str, pretrained: Optional[str] = None,
        precision: str = "fp32", seed: int = 0, *,
        device, master_weights: bool = False,
        force_patch_dropout: Optional[float] = None,
        force_quick_gelu: bool = False,
        force_image_size: Optional[int] = None,
        image_mean: Optional[Tuple[float, ...]] = None,
        image_std: Optional[Tuple[float, ...]] = None,
        image_interpolation: Optional[str] = None,
        image_resize_mode: Optional[str] = None,
        aug_cfg=None, int8_mlp: bool = False
) -> Tuple[CLIPModel, Callable, Callable]:
    """(model, preprocess_train, preprocess_val).  With an `aug_cfg` (the
    contrastive trainer's) preprocess_train is the random-resized-crop
    pipeline drawing from `seed` and this process's rank (as the JAX
    package folds in its process index); without one both are the eval
    pipeline.  `image_mean/std/interpolation/resize_mode` override the
    model's preprocess config; a new mean or std is written into the
    returned model's config, which the evals and attacks normalise by."""
    model = create_model(model_name, pretrained, precision, seed,
                         device=device, master_weights=master_weights,
                         force_patch_dropout=force_patch_dropout,
                         force_quick_gelu=force_quick_gelu,
                         force_image_size=force_image_size,
                         int8_mlp=int8_mlp)
    # the statistics the tower was trained on (MobileCLIP: none, SigLIP:
    # 0.5); None is OpenAI CLIP's
    mean = tuple(image_mean) if image_mean is not None \
        else model.cfg.image_mean
    std = tuple(image_std) if image_std is not None else model.cfg.image_std
    if (mean, std) != (model.cfg.image_mean, model.cfg.image_std):
        model = dataclasses.replace(model, cfg=dataclasses.replace(
            model.cfg, image_mean=mean, image_std=std))
    interp = (image_interpolation
              or getattr(model.cfg, "image_interpolation", None)
              or "bicubic")
    resize_mode = (image_resize_mode
                   or getattr(model.cfg, "image_resize_mode", None)
                   or "shortest")
    size = model.cfg.vision.image_size
    preprocess = image_transform(size, mean=mean, std=std,
                                 interpolation=interp,
                                 resize_mode=resize_mode)
    if aug_cfg:
        return model, train_image_transform(size, mean=mean, std=std,
                                            aug_cfg=aug_cfg,
                                            interpolation=interp,
                                            seed=seed, rank=rank()), \
            preprocess
    return model, preprocess, preprocess


@functools.lru_cache()
def get_tokenizer(model_name: str = ""):
    """Tokenizer for a model name: the CLIP byte-BPE tokenizer, at the
    model's text context (76 for CoCa, whose CLS fills slot 77; 77 for the
    CLIP families, MobileCLIP's included).  A config that names an HF
    tokenizer (SigLIP's SentencePiece, CLIPA's BERT vocabulary, the HF text
    towers' RoBERTa/XLM-R/mT5/NLLB vocabularies) raises: the JAX package
    builds those with `transformers` from their vocabulary files, and
    neither `transformers` nor the files are on the machines the port runs
    on; their towers take token ids (`encode_text`)."""
    if model_name in coca.COCA_CONFIGS:
        cfg = coca.get_coca_config(model_name)
        if cfg.hf_text_name:
            _refuse_hf_tokenizer(model_name, cfg.hf_text_name)
        return _get_bpe(cfg.text.context_length)
    try:
        cfg = get_model_config(model_name) if model_name else None
    except KeyError:
        cfg = None
    if cfg is not None and cfg.text.hf_tokenizer_name:
        _refuse_hf_tokenizer(model_name, cfg.text.hf_tokenizer_name)
    return _get_bpe()


def _refuse_hf_tokenizer(model_name: str, tokenizer: str) -> None:
    raise NotImplementedError(
        f"{model_name}: its tokenizer is {tokenizer!r}, an HF tokenizer "
        "(tokenizer/hf.py's HFTokenizer / SigLipTokenizer), which needs "
        "`transformers` and the tokenizer's vocabulary files; neither is "
        "on the machines the port runs on, so it is not ported; encode "
        "token ids directly")
