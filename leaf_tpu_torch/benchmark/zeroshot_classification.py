"""Zero-shot classification benchmark, clean and under attack (port of
`leaf_tpu/benchmark/zeroshot_classification.py`).

`evaluate_zeroshot_classification` builds the template-ensemble
classifier, then reports top-1, top-5 and the mean per-class recall, the
mean average precision for multilabel targets, and with `attack="apgd"`
the top-1 under the AutoAttack cascade below.  The ImageNet robust eval
calls the cascade directly.

The AutoAttack cascade: APGD on the cross-entropy, then targeted APGD on
the DLR loss against each of the `n_targets` best wrong classes, keeping
for each image the first point that fools the model.  Logits are 100 x
the normalised fp32 image features against the [D, K] classifier, with
TF32 off (the JAX package's `encode_image_model` computes in fp32 by
default).  The vision tower's weights should not require gradients: the
attacks need the images' gradient alone.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from leaf_tpu_torch.attacks.apgd import apgd, ce_loss_fn, dlr_targeted_loss_fn
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.image import _normalize_images
from leaf_tpu_torch.evals.zero_shot import (_clean_logits, _device,
                                            fp32_products)
from leaf_tpu_torch.models.clip import VisionTower
from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.models.zero_shot import build_zero_shot_classifier


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


def average_precision_per_class(scores: np.ndarray,
                                targets: np.ndarray) -> np.ndarray:
    """Per-class average precision for multilabel classification: for each
    class, rank the samples by score and average precision@i over the
    positives."""
    N, C = scores.shape
    rank = np.arange(1, N + 1, dtype=np.float64)
    ap = np.zeros(C)
    for c in range(C):
        order = np.argsort(-scores[:, c], kind="stable")
        truth = targets[order, c] > 0
        if not truth.any():
            continue
        precision = np.cumsum(truth) / rank
        ap[c] = precision[truth].mean()
    return ap


def waited(batches: Iterable, clock: Dict[str, float]) -> Iterator:
    """Iterate `batches`, adding the seconds spent waiting for each item
    (the host's decoding and resizing, where the loader has not kept up)
    to `clock["data"]`."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        finally:
            clock["data"] = clock.get("data", 0.0) + time.perf_counter() - t0
        yield item


def text_features(text, cfg: CLIPConfig, tokenizer, texts: Sequence[str],
                  batch_size: int = 256) -> np.ndarray:
    """Normalised fp32 features [N, D] of `texts` on the host, encoded
    `batch_size` at a time at their length bucket."""
    scorer = CandidateScorer(cfg, _device(text))
    feats = []
    with fp32_products():
        for i in range(0, len(texts), batch_size):
            feats.append(scorer.encode_text(
                text, tokenizer(list(texts[i:i + batch_size])),
                normalize=True).float().cpu().numpy())
    return np.concatenate(feats, 0)


@torch.no_grad()
def image_features(visual: VisionTower, cfg: CLIPConfig,
                   images: np.ndarray) -> np.ndarray:
    """Normalised fp32 features [B, D] on the host of un-normalised
    [B, H, W, 3] images in [0, 1]."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    with fp32_products():
        feats = visual.encode_image(
            _normalize_images(x.to(_device(visual)), cfg), normalize=True)
        return feats.float().cpu().numpy()


def zero_shot_classifier(text, cfg: CLIPConfig, tokenizer,
                         classnames: Sequence[str],
                         templates: Sequence) -> torch.Tensor:
    """The [D, K] fp32 classifier on the text tower's device, 10 classes a
    call, each call's prompts at their length bucket."""
    scorer = CandidateScorer(cfg, _device(text))
    with fp32_products():
        return build_zero_shot_classifier(
            lambda t: scorer.encode_text(text, t), tokenizer, classnames,
            templates, num_classes_per_batch=10)


def evaluate_zeroshot_classification(
    model,
    cfg: CLIPConfig,
    tokenizer,
    loader,                        # yields (images [B,H,W,3] in [0,1], labels)
    classnames: Sequence[str],
    templates: Sequence,
    attack: Optional[str] = None,  # None | 'apgd'
    eps: float = 2 / 255,
    n_iter: int = 100,
    seconds: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Zero-shot top-1/top-5/mean per-class recall of the `CLIP` module
    `model` over `loader` (the mean average precision where the labels
    are 0/1 rows), with `attack="apgd"` also the top-1 under the cascade.
    The towers compute in their weights' dtype, the logits in fp32 with
    TF32 off; the attack needs an fp32 vision tower.  `seconds`, if given,
    gains the wall seconds of the classifier, of the waits for the loader
    ("data"), of the clean logits ("clean") and of the attack ("apgd"),
    each ending in a copy to the host."""
    clock = seconds if seconds is not None else {}
    visual = model.visual
    if attack not in (None, "apgd"):
        raise ValueError(f"unknown attack {attack!r}")
    if attack and visual.dtype != torch.float32:
        raise ValueError(
            "the APGD cascade computes the logits in float32; the vision "
            f"tower computes in {visual.dtype} (use --precision fp32)")
    device = _device(visual)
    t0 = time.perf_counter()
    classifier = zero_shot_classifier(model.text, cfg, tokenizer,
                                      classnames, templates)
    if classifier.is_cuda:
        torch.cuda.synchronize(device)
    clock["classifier"] = clock.get("classifier", 0.0) \
        + time.perf_counter() - t0

    n_cls = len(classnames)
    top1 = top5 = n = 0
    robust1 = 0
    per_class_correct = np.zeros(n_cls)
    per_class_count = np.zeros(n_cls)
    ml_logits, ml_targets = [], []
    for images, labels in waited(loader, clock):
        t0 = time.perf_counter()
        labels_np = np.asarray(labels)
        images = torch.from_numpy(np.ascontiguousarray(
            images, dtype=np.float32)).to(device)
        with fp32_products():
            logits = _clean_logits(visual, cfg, images,
                                   classifier).cpu().numpy()
        clock["clean"] = clock.get("clean", 0.0) + time.perf_counter() - t0
        if labels_np.ndim == 2:
            # multilabel targets (voc2007_multilabel): mAP at the end
            if attack:
                raise ValueError(
                    "adversarial evaluation is not defined for multilabel "
                    "datasets (the APGD cascade needs a single ground-truth "
                    "class)")
            ml_logits.append(logits)
            ml_targets.append(labels_np)
            n += len(labels_np)
            continue
        rank = (-logits).argsort(-1)
        correct1 = rank[:, 0] == labels_np
        top1 += correct1.sum()
        top5 += (rank[:, :min(5, n_cls)] == labels_np[:, None]).any(-1).sum()
        np.add.at(per_class_correct, labels_np, correct1)
        np.add.at(per_class_count, labels_np, 1)
        if attack == "apgd":
            t0 = time.perf_counter()
            _, fooled = _apgd_attack_batch(
                visual, cfg, classifier, images,
                torch.from_numpy(labels_np).to(device), eps, n_iter=n_iter)
            robust1 += int((~fooled.cpu().numpy() & correct1).sum())
            clock["apgd"] = clock.get("apgd", 0.0) + time.perf_counter() - t0
        n += len(labels_np)

    if ml_logits:
        ap = average_precision_per_class(np.concatenate(ml_logits),
                                         np.concatenate(ml_targets))
        return {"mean_average_precision": float(ap.mean()), "n": n}

    seen = per_class_count > 0
    out = {
        "acc1": top1 / max(n, 1),
        "acc5": (top5 / max(n, 1)) if n_cls >= 5 else None,
        "mean_per_class_recall": float(
            (per_class_correct[seen] / per_class_count[seen]).mean())
        if seen.any() else 0.0,
        "n": n,
    }
    if attack == "apgd":
        out["robust_acc1"] = robust1 / max(n, 1)
    return out
