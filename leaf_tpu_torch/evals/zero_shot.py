"""In-training zero-shot evaluation (port of `leaf_tpu/evals/zero_shot.py`).

  * ImageNet zero-shot: the template-ensemble classifier, clean top-1 and
    top-5, and top-1 under PGD (`run_imagenet_eval`);
  * image-anchored zero-shot text classification on AG-News / SST-2: the
    batched Charmer classification attack, clean and adversarial accuracy
    (`run_text_classification`).

Reference quirks kept: the classification attack runs on the raw
sentence while the final scoring applies the caption template; clean
logits are scaled by 100 (argmax-equivalent).

Precision is the JAX package's: images are encoded, and PGD runs, in
fp32 (the vision tower holds fp32 weights, `factory.create_model(...,
master_weights=True)`), with TF32 off for those products; text encodes
(the classifier, the Charmer grids, the templated scoring) run in the
text tower's compute dtype, the scorer's precision.  The towers are
passed as one `models.clip.CLIP` module: `.text` (the trainer's current
text tower) and `.visual`.
"""
from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.image import _normalize_images, attack_image_classification
from leaf_tpu_torch.models.clip import CLIP, TextTower, VisionTower
from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.models.zero_shot import (build_zero_shot_classifier,
                                             imagenet_classnames,
                                             openai_imagenet_templates)

LOG = logging.getLogger(__name__)


@contextlib.contextmanager
def fp32_products():
    """TF32 off for the fp32 products inside (cuBLAS and cuDNN), as
    `jax_default_matmul_precision=highest`; the flags are restored on
    exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.no_grad()
def _clean_logits(visual: VisionTower, cfg: CLIPConfig, images: torch.Tensor,
                  classifier: torch.Tensor) -> torch.Tensor:
    feats = visual.encode_image(_normalize_images(images, cfg),
                                normalize=True).float()
    return 100.0 * feats @ classifier.float()


def run_imagenet_eval(visual: VisionTower, cfg: CLIPConfig,
                      classifier: torch.Tensor, loader,
                      generator: Optional[torch.Generator] = None,
                      eps: float = 2 / 255, n_steps: int = 10,
                      stepsize: Optional[float] = None,
                      attack: bool = True,
                      seconds: Optional[Dict[str, float]] = None):
    """(top1, top5, top1_adv) over an (images, labels) batch loader.
    Images arrive un-normalised (the attack works in pixel space).
    `seconds`, if given, has its "clean" and "pgd" entries raised by the
    wall seconds of the clean encodes (with the loader's waits) and of
    the attack with its encode, each ending in a copy to the host."""
    device = _device(visual)
    clock = {"clean": 0.0, "pgd": 0.0}
    top1 = top5 = top1_adv = n = 0
    with fp32_products():
        t0 = time.perf_counter()
        for images, labels in loader:
            labels = np.asarray(labels)
            images = torch.from_numpy(np.ascontiguousarray(
                images, dtype=np.float32)).to(device)
            logits = _clean_logits(visual, cfg, images, classifier)
            rank = (-logits.cpu().numpy()).argsort(axis=-1)
            top1 += (rank[:, 0] == labels).sum()
            top5 += (rank[:, :5] == labels[:, None]).any(axis=-1).sum()
            t1 = time.perf_counter()
            clock["clean"] += t1 - t0
            if attack:
                adv = attack_image_classification(
                    visual, cfg, images, classifier,
                    torch.from_numpy(labels).to(device), generator,
                    eps=eps, n_steps=n_steps, stepsize=stepsize)
                logits_adv = _clean_logits(visual, cfg, adv, classifier)
                top1_adv += (logits_adv.argmax(-1).cpu().numpy()
                             == labels).sum()
            n += len(labels)
            t0 = time.perf_counter()
            clock["pgd"] += t0 - t1
    if seconds is not None:
        for key, value in clock.items():
            seconds[key] = seconds.get(key, 0.0) + value
    if n == 0:
        return 0.0, 0.0, 0.0
    return top1 / n, top5 / n, (top1_adv / n if attack else 0.0)


def run_text_classification(scorer: CandidateScorer, text: TextTower,
                            tokenizer, image_features, textcls,
                            n_charmer: int = 20, k: int = 1,
                            n_val: Optional[int] = None,
                            attack_batch: int = 16):
    """(clean_acc, adv_acc): the Charmer classification attack against
    image-anchored class embeddings, `attack_batch` sentences at a time
    (each sentence's search is the reference's sequential one)."""
    from leaf_tpu_torch.attacks.text import (
        attack_text_charmer_classification_batched)
    samples = textcls.samples[:n_val] if n_val is not None \
        else textcls.samples
    # length-sorted chunks keep each chunk's grid width and context
    # bucket at the chunk's longest sentence, not the dataset's; searches
    # are independent per sentence and only accuracies leave, so the
    # order needs no restoring
    samples = sorted(samples, key=lambda d: len(d["text"]))
    anchors = torch.as_tensor(image_features).float().to(scorer.device)
    acc = acc_adv = n = 0
    template = textcls.template
    for start in range(0, len(samples), attack_batch):
        chunk = samples[start:start + attack_batch]
        sentences = [d["text"] for d in chunk]
        labels = np.asarray([d["label"] for d in chunk])
        adv_sentences = attack_text_charmer_classification_batched(
            scorer, text, tokenizer, sentences, anchors, labels,
            n=n_charmer, k=k, vocab=textcls.vocab)
        tokens = tokenizer([template.format(s) for s in sentences]
                           + [template.format(s) for s in adv_sentences])
        feats = scorer.encode_text(text, tokens, normalize=True).float()
        preds = (feats @ anchors.T).argmax(-1).cpu().numpy()
        B = len(chunk)
        acc += int((preds[:B] == labels).sum())
        acc_adv += int((preds[B:] == labels).sum())
        n += B
    if n == 0:
        return 0.0, 0.0
    return acc / n, acc_adv / n


def encode_anchor_images(visual: VisionTower, cfg: CLIPConfig, textcls,
                         preprocess) -> torch.Tensor:
    """Normalised class-anchor image embeddings [K, D], fp32 products."""
    images = torch.from_numpy(textcls.anchor_images(preprocess)).to(
        _device(visual), torch.float32)
    with fp32_products(), torch.no_grad():
        return visual.encode_image(_normalize_images(images, cfg),
                                   normalize=True)


def _classifier(scorer: CandidateScorer, text: TextTower,
                tokenizer) -> torch.Tensor:
    return build_zero_shot_classifier(
        lambda toks: scorer.encode_text(text, toks), tokenizer,
        imagenet_classnames(), openai_imagenet_templates(),
        num_classes_per_batch=10)


def zero_shot_eval(model: CLIP, cfg: CLIPConfig, data: Dict, tokenizer,
                   preprocess, epoch: int, args,
                   scorer: Optional[CandidateScorer] = None,
                   generator: Optional[torch.Generator] = None,
                   seconds: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """The full zero-shot eval pass of the trainer.  `generator` draws
    the PGD starts (default: seeded with `args.seed` on the model's
    device); `seconds`, if given, collects the wall seconds of each part:
    "classifier", "clean", "pgd" and "text_classification" (the anchor
    encodes with it), each ending in a copy to the host."""
    if not any(k in data for k in
               ("imagenet-val", "imagenet-v2", "train-agnews", "train-sst2",
                "val-agnews", "val-sst2")):
        return {}
    zf = getattr(args, "zeroshot_frequency", 1)
    if zf == 0:
        return {}
    if (epoch % zf) != 0 and epoch != getattr(args, "epochs", epoch):
        return {}

    clock = seconds if seconds is not None else {}

    def tick(name, t0):
        clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0

    device = _device(model)
    if scorer is None:
        scorer = CandidateScorer(cfg, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            getattr(args, "seed", 0))
    results: Dict[str, float] = {}

    if "imagenet-val" in data or "imagenet-v2" in data:
        LOG.info("Building zero-shot classifier")
        t0 = time.perf_counter()
        classifier = _classifier(scorer, model.text, tokenizer)
        if classifier.is_cuda:
            torch.cuda.synchronize(classifier.device)
        tick("classifier", t0)
        for name, out_prefix in (("imagenet-val", "imagenet"),
                                 ("imagenet-v2", "imagenetv2")):
            if name not in data:
                continue
            top1, top5, top1_adv = run_imagenet_eval(
                model.visual, cfg, classifier, data[name].loader, generator,
                eps=getattr(args, "eps_adv", 2 / 255),
                n_steps=getattr(args, "n_steps_adv", 10),
                stepsize=getattr(args, "stepsize_adv", None), seconds=clock)
            results[f"{out_prefix}-zeroshot-val-top1"] = top1
            results[f"{out_prefix}-zeroshot-val-top5"] = top5
            # the reference writes both splits' adversarial accuracy to
            # one un-prefixed key, so imagenet-v2's would overwrite
            # imagenet-val's: the v2 key is prefixed instead
            adv_key = ("imagenet-zeroshot-val-top1-adv"
                       if out_prefix == "imagenet" else
                       f"{out_prefix}-zeroshot-val-top1-adv")
            results[adv_key] = top1_adv

    for split in ("val", "train"):
        for name in ("agnews", "sst2"):
            dkey = f"{split}-{name}"
            if dkey not in data:
                continue
            textcls = data[dkey]
            t0 = time.perf_counter()
            anchors = encode_anchor_images(model.visual, cfg, textcls,
                                           preprocess)
            acc, acc_adv = run_text_classification(
                scorer, model.text, tokenizer, anchors, textcls,
                n_charmer=getattr(args, "n_charmer_test", 20),
                k=getattr(args, "k_adv_test", 1),
                n_val=getattr(args, "n_val_text", None))
            tick("text_classification", t0)
            results[f"{name}-zeroshot-{split}-acc"] = acc
            results[f"{name}-zeroshot-{split}-acc-adv"] = acc_adv

    return results


def imagenet_zero_shot_clean(model: CLIP, cfg: CLIPConfig, datainfo,
                             tokenizer) -> Dict[str, float]:
    """Clean-only ImageNet zero-shot top-1/top-5 (the contrastive
    trainer's eval)."""
    scorer = CandidateScorer(cfg, _device(model))
    classifier = _classifier(scorer, model.text, tokenizer)
    top1, top5, _ = run_imagenet_eval(model.visual, cfg, classifier,
                                      datainfo.loader, attack=False)
    return {"imagenet-zeroshot-val-top1": top1,
            "imagenet-zeroshot-val-top5": top5}
