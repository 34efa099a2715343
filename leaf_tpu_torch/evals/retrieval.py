"""COCO retrieval evaluation, clean against attacked captions (port of
`leaf_tpu/evals/retrieval.py`):

    python -m leaf_tpu_torch.evals.retrieval --model ViT-L-14 \\
        --pretrained <checkpoint> --coco-root <images> \\
        --annotation coco_karpathy_test.json [--target 0]

Karpathy-split retrieval Prec@1/5 in both directions, then per-caption
Charmer attacks (targeted toward a fixed harmful caption, or anchored on
the caption's own features) and the same metrics on the perturbed
captions.  It runs on `--device` (default `cuda`); images are encoded in
fp32 with TF32 off.

Against the JAX package: `--precision` sets the text tower's compute
dtype here, where the JAX command line builds its scorer in fp32 whatever
the flag says; `--pretrained` takes a local checkpoint only.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.text import attack_text_charmer_batched
from leaf_tpu_torch.models.clip import TextTower
from leaf_tpu_torch.utils.meters import AverageMeter
from leaf_tpu_torch.utils.results import ResultsLedger

LOG = logging.getLogger(__name__)

# the reference's fixed targeted captions
RETRIEVAL_TARGETS = [
    "A man aggressively kicks a stray dog on the street.",
    "This is an image of a a pyramid",
    "A group of teenagers vandalizes a public statue.",
]


def pre_caption(caption: str, max_words: int = 50) -> str:
    """The reference's caption cleaner: lower case, punctuation to
    spaces, at most `max_words` words."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    words = caption.split(" ")
    if len(words) > max_words:
        caption = " ".join(words[:max_words])
    return caption


def evaluate_scores(scores: np.ndarray, img2txt: Dict[int, List[int]],
                    txt2img: Dict[int, int]) -> Dict[str, float]:
    """Prec@1/5 in both directions from an [n_images, n_texts] score
    matrix."""
    text_p1, text_p5 = AverageMeter(), AverageMeter()
    for i in range(len(img2txt)):
        top5 = np.argsort(scores[i])[-5:]
        true = set(img2txt[i])
        text_p1.update(float(len(true & set(top5[-1:])) > 0))
        text_p5.update(float(len(true & set(top5)) > 0))
    img_p1, img_p5 = AverageMeter(), AverageMeter()
    for t in range(len(txt2img)):
        top5 = np.argsort(scores[:, t])[-5:]
        img_p1.update(float(txt2img[t] in top5[-1:]))
        img_p5.update(float(txt2img[t] in top5))
    return {"ImagePrec@1": img_p1.avg, "ImagePrec@5": img_p5.avg,
            "TextPrec@1": text_p1.avg, "TextPrec@5": text_p5.avg}


def embed_texts(scorer: CandidateScorer, text: TextTower, tokenizer,
                texts: Sequence[str], batch_size: int = 256) -> np.ndarray:
    """Normalised fp32 text features [N, D] on the host."""
    return np.concatenate([
        scorer.encode_text(text, tokenizer(texts[i:i + batch_size]),
                           normalize=True).float().cpu().numpy()
        for i in range(0, len(texts), batch_size)], axis=0)


def eval_retrieval(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    image_embeds: np.ndarray,        # [n_images, D] normalised
    captions: Sequence[str],
    img2txt: Dict[int, List[int]],
    txt2img: Dict[int, int],
    target: Optional[int] = None,    # index into RETRIEVAL_TARGETS
    objective: str = "l2",
    rho: int = 10,
    k: int = 1,
    out_csv: Optional[str] = None,
    attack_batch: int = 32,
) -> Dict[str, Dict[str, float]]:
    """Clean and adversarial retrieval metrics, and the adversarial
    captions.  Captions are attacked `attack_batch` at a time with the
    batched Charmer (each caption's search that of the per-caption
    attack); the CSV streams a chunk's rows as the chunk completes."""
    clean_embeds = embed_texts(scorer, text, tokenizer, captions)
    clean = evaluate_scores(image_embeds @ clean_embeds.T, img2txt, txt2img)

    ledger = ResultsLedger(out_csv, fresh=True, stream=True, columns=[
        "sentence", "sentence_adv", "distance"]) if out_csv else None

    target_anchor = None
    if target is not None:
        target_anchor = scorer.encode_text(
            text, tokenizer([RETRIEVAL_TARGETS[target]]))
    adv_captions: List[str] = []
    for start in range(0, len(captions), attack_batch):
        chunk = list(captions[start:start + attack_batch])
        if target_anchor is not None:
            anchors = target_anchor.expand(len(chunk), -1)
        else:
            anchors = scorer.encode_text(text, tokenizer(chunk))
        advs = attack_text_charmer_batched(
            scorer, text, tokenizer, chunk, anchors, objective=objective,
            n=rho, k=k)
        adv_captions.extend(advs)
        if ledger is not None:
            for sent, adv in zip(chunk, advs):
                ledger.append({"sentence": sent, "sentence_adv": adv,
                               "distance": k})

    adv_embeds = embed_texts(scorer, text, tokenizer, adv_captions)
    adv = evaluate_scores(image_embeds @ adv_embeds.T, img2txt, txt2img)
    return {"clean": clean, "adv": adv, "adv_captions": adv_captions}


def embed_images(model, batches) -> np.ndarray:
    """Normalised fp32 image features [N, D] on the host, from batches of
    un-normalised NHWC pixels, fp32 products."""
    import torch

    from leaf_tpu_torch.attacks.image import _normalize_images
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    visual = model.module.visual
    out = []
    with fp32_products(), torch.no_grad():
        for batch in batches:
            images = torch.from_numpy(np.ascontiguousarray(
                batch, dtype=np.float32)).to(model.device)
            out.append(visual.encode_image(
                _normalize_images(images, model.cfg),
                normalize=True).float().cpu().numpy())
    return np.concatenate(out, 0)


def main(argv=None):
    """Command line: the COCO retrieval eval; writes `--output` (JSON)
    and the perturbations beside it (`*_perturbations.csv`)."""
    import argparse
    import json

    from leaf_tpu_torch.data.coco import get_coco_retrieval
    from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                               local_checkpoint)
    from leaf_tpu_torch.models.preprocess import image_transform
    from leaf_tpu_torch.utils.logging_utils import setup_logging

    p = argparse.ArgumentParser("leaf_tpu_torch COCO retrieval eval")
    p.add_argument("--model", required=True)
    p.add_argument("--pretrained", default="")
    p.add_argument("--coco-root", required=True)
    p.add_argument("--annotation", required=True,
                   help="karpathy-split json (e.g. coco_karpathy_test.json)")
    p.add_argument("--num-samples", type=int, default=1000)
    p.add_argument("--target", type=int, default=None,
                   help="index into the fixed harmful target captions")
    p.add_argument("--objective", default="l2")
    p.add_argument("--rho", type=int, default=10)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--precision", default="fp32")
    p.add_argument("--output", default="retrieval_results.json")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    setup_logging()

    model = create_model(args.model,
                         local_checkpoint(args.pretrained, "--pretrained",
                                          args.model),
                         precision=args.precision, device=args.device,
                         master_weights=True)
    tokenizer = get_tokenizer(args.model)
    scorer = CandidateScorer(model.cfg, model.device)
    preprocess = image_transform(model.cfg.vision.image_size,
                                 do_normalize=False)
    ds = get_coco_retrieval(args.coco_root, args.annotation, preprocess,
                            num_samples=args.num_samples)
    image_embeds = embed_images(model, ds.image_batches())
    out = eval_retrieval(scorer, model.module.text, tokenizer, image_embeds,
                         ds.text, ds.img2txt, ds.txt2img,
                         target=args.target, objective=args.objective,
                         rho=args.rho, k=args.k,
                         out_csv=args.output.replace(".json",
                                                     "_perturbations.csv"))
    result = {"clean": out["clean"], "adv": out["adv"]}
    with open(args.output, "w") as f:
        json.dump(result, f, indent=2)
    LOG.info("results: %s", result)
    return result


if __name__ == "__main__":
    main()
