"""Zero-shot classification under attack (the part of
`leaf_tpu/benchmark/zeroshot_classification.py` that the ImageNet robust
eval calls; the rest of the benchmark is ROADMAP Queue 1 item 12).

The AutoAttack cascade: APGD on the cross-entropy, then targeted APGD on
the DLR loss against each of the `n_targets` best wrong classes, keeping
for each image the first point that fools the model.  Logits are 100 x
the normalised fp32 image features against the [D, K] classifier, with
TF32 off (the JAX package's `encode_image_model` computes in fp32 by
default).  The vision tower's weights should not require gradients: the
attacks need the images' gradient alone.
"""
from __future__ import annotations

from typing import Callable

import torch

from leaf_tpu_torch.attacks.apgd import apgd, ce_loss_fn, dlr_targeted_loss_fn
from leaf_tpu_torch.attacks.image import _normalize_images
from leaf_tpu_torch.evals.zero_shot import fp32_products
from leaf_tpu_torch.models.clip import VisionTower
from leaf_tpu_torch.models.config import CLIPConfig


def _logits_fn(visual: VisionTower, cfg: CLIPConfig,
               classifier: torch.Tensor) -> Callable:
    """images [B, H, W, 3] in [0, 1] -> fp32 zero-shot logits [B, K]."""
    if visual.dtype != torch.float32:
        raise ValueError(f"the zero-shot logits are computed in float32; "
                         f"the vision tower computes in {visual.dtype}")
    classifier = classifier.float()

    def f(images):
        with fp32_products():
            feats = visual.encode_image(_normalize_images(images, cfg),
                                        normalize=True)
            return 100.0 * feats.float() @ classifier
    return f


def _apgd_ce(visual, cfg, classifier, images, labels, eps, n_iter: int,
             norm: str):
    """APGD-CE: (adversarial images, fooled [B], classes ranked by the
    clean logits [B, K])."""
    logits_fn = _logits_fn(visual, cfg, classifier)
    adv = apgd(ce_loss_fn(logits_fn, labels), images, norm=norm, eps=eps,
               n_iter=n_iter)
    with torch.no_grad():
        fooled = logits_fn(adv).argmax(-1) != labels
        ranked = torch.argsort(-logits_fn(images), dim=-1, stable=True)
    return adv, fooled, ranked


def _apgd_targeted(visual, cfg, classifier, images, labels, target, eps,
                   n_iter: int, norm: str):
    """Targeted APGD-DLR toward `target` [B]: (adversarial images,
    fooled [B])."""
    logits_fn = _logits_fn(visual, cfg, classifier)
    adv = apgd(dlr_targeted_loss_fn(logits_fn, labels, target), images,
               norm=norm, eps=eps, n_iter=n_iter)
    with torch.no_grad():
        return adv, logits_fn(adv).argmax(-1) != labels


def _apgd_attack_batch(visual, cfg: CLIPConfig, classifier, images, labels,
                       eps, n_iter: int = 100, n_targets: int = 3,
                       norm: str = "linf"):
    """The cascade on one batch: (images that fooled the model where one
    was found, else the clean ones; fooled [B]).  `norm` is linf, l2 or
    l1, the AutoAttack presets."""
    labels = labels.long()
    adv, fooled, ranked = _apgd_ce(visual, cfg, classifier, images, labels,
                                   eps, n_iter, norm)
    best = torch.where(fooled.reshape(-1, 1, 1, 1), adv, images)
    for t in range(1, n_targets + 1):
        adv_t, fooled_t = _apgd_targeted(visual, cfg, classifier, images,
                                         labels, ranked[:, t], eps, n_iter,
                                         norm)
        take = fooled_t & ~fooled
        best = torch.where(take.reshape(-1, 1, 1, 1), adv_t, best)
        fooled = fooled | fooled_t
    return best, fooled
