"""Model factory: name -> model, transforms and tokenizer (port of
`leaf_tpu/models/factory.py` for CLIP-ViT configs).

Weights are made on the CPU, from the given checkpoint or from a seeded
`torch.Generator` with the JAX package's init distributions, then moved
to the requested device, so a CPU copy and a CUDA copy of one seed hold
identical weights.  Precision then casts the matrix weights and
embeddings to the working dtype once; LayerNorm parameters (and the
logit scale) stay fp32, as the JAX package casts at each use.  That one
rounding is right for serving and wrong for an optimizer whose updates
are smaller than a bf16 step: with `master_weights` the text tower keeps
its fp32 weights and casts them where it uses them.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch.models import interop
from leaf_tpu_torch.models.clip import CLIP
from leaf_tpu_torch.models.config import CLIPConfig, get_model_config
from leaf_tpu_torch.models.layers import LayerNorm
from leaf_tpu_torch.models.preprocess import (image_transform,
                                              train_image_transform)
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


def _cast_weights(module: torch.nn.Module, dtype: torch.dtype) -> None:
    """Matrix weights, biases and embeddings of `module` and its
    submodules to `dtype`; LayerNorm parameters and the CLIP-level
    scalars stay fp32."""
    for m in module.modules():
        if isinstance(m, (LayerNorm, CLIP)):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)


def local_checkpoint(path: Optional[str], flag: str = "--pretrained"
                     ) -> Optional[str]:
    """`path` when it is None or names a local checkpoint file or
    directory; a registry tag or hub id raises, naming where ROADMAP.md
    queues the registry."""
    if path and not os.path.exists(path):
        raise NotImplementedError(
            f"{flag} {path!r}: registry tags and hub ids "
            "(models/pretrained.py) are not ported to leaf_tpu_torch yet: "
            "ROADMAP Queue 1 item 11; pass a local checkpoint")
    return path or None


def _adopt_activation(cfg: CLIPConfig, model_name: str, pretrained: str,
                      force_quick_gelu: bool) -> CLIPConfig:
    """The activation the checkpoint declares (`interop.
    checkpoint_quick_gelu`) wins over the config's, unless QuickGELU was
    forced; either way a disagreement is logged."""
    ckpt_qg = interop.checkpoint_quick_gelu(pretrained)
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


def create_model(model_name: str, pretrained: Optional[str] = None,
                 precision: str = "fp32", seed: int = 0, *,
                 device, master_weights: bool = False,
                 force_patch_dropout: Optional[float] = None,
                 force_quick_gelu: bool = False,
                 int8_mlp: bool = False) -> CLIPModel:
    """Build a CLIP model by registry name on `device` ('cuda', 'cpu',
    ...).  `pretrained` is a local HF or OpenCLIP checkpoint file or
    snapshot directory; without it the weights are a seeded random init.
    A checkpoint's declared activation (its `open_clip_config.json` or HF
    `config.json`) is adopted unless `force_quick_gelu`, and its vision
    position grid is resized to the config's resolution.

    `master_weights` is the JAX package's precision policy, for the
    trainer and the evals: the text tower's weights stay fp32 and it
    computes in `precision` (`TextTower.compute_dtype`); the vision tower
    stays fp32 and computes in fp32, since the evals encode images (and
    run PGD) in fp32, as the JAX package's do; a trainer of the vision
    tower sets its `compute_dtype`.  `force_patch_dropout` sets the vision
    config's train-time `patch_dropout`.  `int8_mlp` stores every MLP
    weight as int8 with per-column scales (`models.quantize`), quantized
    from the fp32 weights before the cast to `precision`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    cfg = get_model_config(model_name)
    if force_quick_gelu:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
    if force_patch_dropout is not None:
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, patch_dropout=force_patch_dropout))
    if pretrained:
        if not os.path.exists(pretrained):
            raise FileNotFoundError(
                f"{pretrained!r} does not exist (pretrained registry tags and "
                "hub ids are not ported yet: pass a local checkpoint)")
        cfg = _adopt_activation(cfg, model_name, pretrained, force_quick_gelu)
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
        aug_cfg=None, int8_mlp: bool = False
) -> Tuple[CLIPModel, Callable, Callable]:
    """(model, preprocess_train, preprocess_val).  With an `aug_cfg` (the
    contrastive trainer's) preprocess_train is the random-resized-crop
    pipeline drawing from `seed`; without one both are the eval
    pipeline."""
    model = create_model(model_name, pretrained, precision, seed,
                         device=device, master_weights=master_weights,
                         force_patch_dropout=force_patch_dropout,
                         int8_mlp=int8_mlp)
    size = model.cfg.vision.image_size
    preprocess = image_transform(size)
    if aug_cfg:
        return model, train_image_transform(size, aug_cfg=aug_cfg,
                                            seed=seed), preprocess
    return model, preprocess, preprocess


@functools.lru_cache()
def get_tokenizer(model_name: str = ""):
    """Tokenizer for a model name: the CLIP byte-BPE tokenizer (the only
    one the registry's configs use so far)."""
    return _get_bpe()
