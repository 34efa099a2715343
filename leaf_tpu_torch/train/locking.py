"""LiT-style partial tower locking for the contrastive trainer (port of
`leaf_tpu/train/locking.py`).

A lock is a 0/1 multiplier per parameter on the optimizer's final update,
as the JAX package's `mask_updates` chained after clip, Adam and decay: a
locked parameter still has its gradient, which counts in the global norm
of `--grad-clip-norm`, and Adam's moments still follow it, but neither
the step nor the weight decay moves it.  `train.optim.make_optimizer`
puts parameters of multiplier 0 in parameter groups whose learning rate
is scaled by 0, which is that mask exactly.

The JAX package stacks a tower's blocks on one leaf, so "the last n
layers" is a multiplier per slice there; here `blocks` is a `ModuleList`
and each block's parameters are its own, so every multiplier is per
parameter.  The groups are those of `vision_lock_multipliers` and
`text_lock_multipliers` as the JAX code has them: vision groups, last to
first, are `proj` | the last block + `ln_post` | each other block | the
stem (patch, class and positional embeddings, `ln_pre`), and
`unlocked_groups = n` unlocks the last n (a tower without blocks locks
whole); text embeddings are always
locked, the last `unlocked_layers` blocks are not, and `ln_final` and
`text_projection` are unlocked only when some block is (`ln_final` also
whenever `freeze_layer_norm` is off, as are the locked blocks'
LayerNorms).
"""
from __future__ import annotations

from typing import Dict

from leaf_tpu_torch.models.clip import CLIP, TextTower, VisionTower

_LN_KEYS = ("ln_1", "ln_2")


def vision_lock_multipliers(visual: VisionTower,
                            unlocked_groups: int = 0) -> Dict[str, float]:
    """{name within the tower: 0.0 or 1.0}; 0 groups freezes it all.

    The groups are a ViT's, and apply to every tower with a `blocks`
    stack, as in the JAX package, whose rule reads the tree's top-level
    keys: the MobileCLIP MCi-ViT, EVA, ViTamin and RelPos-ViT trunks
    included, whose parts other than `blocks`, `proj` and `ln_post` are
    the stem there too.  A tower without one (ModifiedResNet, ConvNeXt,
    FastViT, Swin) is locked whole, and unlocked groups raise, as JAX
    raises (`leaf_tpu/train/locking.py:66-77`).  A tower whose blocks nest
    deeper than a ViT's (EVA02's inner LayerNorms, ViTamin's MLP norm,
    RelPos-ViT's bias MLP) raises: the JAX rule fails on it."""
    if not hasattr(visual, "blocks"):
        if unlocked_groups:
            raise ValueError(
                "--lock-image-unlocked-groups is implemented for ViT "
                "towers (the reference defines separate group lists per "
                "trunk, transformer.py:541 vs modified_resnet.py); use "
                "full locking (0) for this tower")
        return {name: 0.0 for name, _ in visual.named_parameters()}
    deep = sorted({".".join(name.split(".")[2:]) for name, _ in
                   visual.named_parameters()
                   if name.startswith("blocks.") and name.count(".") > 3})
    if deep:
        raise NotImplementedError(
            "--lock-image on this tower: the JAX package's rule takes a "
            "block's parameters at most two levels deep and fails on its "
            f"{', '.join(deep)} (leaf_tpu/train/locking.py:51-63); the "
            "tower has no lock groups, in the JAX package as here")
    n_layers, n = len(visual.blocks), unlocked_groups
    proj_ok = n >= 1
    last_ok = n >= 2
    n_mid = max(0, min(n - 2, n_layers - 1))   # of blocks[0 .. L-2]
    stem_ok = n >= n_layers + 2
    mult = {}
    for name, _ in visual.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            i = int(parts[1])
            ok = (last_ok if i == n_layers - 1
                  else i >= n_layers - 1 - n_mid)
        elif parts[0] == "proj":
            ok = proj_ok
        elif parts[0] == "ln_post":
            ok = last_ok
        else:
            ok = stem_ok
        mult[name] = float(ok)
    return mult


def text_lock_multipliers(text: TextTower, unlocked_layers: int = 0,
                          freeze_layer_norm: bool = True) -> Dict[str, float]:
    """{name within the tower: 0.0 or 1.0}.  An HF text tower (no
    `blocks`) is locked whole, its LayerNorms following
    `freeze_layer_norm`, and unlocked layers raise, as in the JAX
    package."""
    if not hasattr(text, "blocks"):
        if unlocked_layers:
            raise ValueError(
                "--lock-text-unlocked-layers > 0 is implemented for the "
                "native text tower; HF towers support full locking only")
        return {name: float(not freeze_layer_norm and any(
            "layernorm" in part.lower().replace("_", "")
            for part in name.split(".")))
            for name, _ in text.named_parameters()}
    n_layers = len(text.blocks)
    n = min(unlocked_layers, n_layers)
    tail_ok = n > 0
    mult = {}
    for name, _ in text.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            ok = (int(parts[1]) >= n_layers - n
                  or (not freeze_layer_norm and parts[2] in _LN_KEYS))
        elif parts[0] == "ln_final":
            ok = tail_ok or not freeze_layer_norm
        elif parts[0] == "text_projection":
            ok = tail_ok
        else:   # token and positional embeddings
            ok = False
        mult[name] = float(ok)
    return mult


def lock_multipliers(model: CLIP, lock_image: bool = False,
                     lock_image_unlocked_groups: int = 0,
                     lock_text: bool = False,
                     lock_text_unlocked_layers: int = 0,
                     lock_text_freeze_layer_norm: bool = True
                     ) -> Dict[str, float]:
    """{parameter name of `model`: multiplier}, 1.0 = trainable."""
    mult = {name: 1.0 for name, _ in model.named_parameters()}
    if lock_image:
        mult.update({f"visual.{k}": v for k, v in vision_lock_multipliers(
            model.visual, lock_image_unlocked_groups).items()})
    if lock_text:
        mult.update({f"text.{k}": v for k, v in text_lock_multipliers(
            model.text, lock_text_unlocked_layers,
            lock_text_freeze_layer_norm).items()})
    return mult

