"""Standalone zero-shot adversarial text-classification eval (port of
`leaf_tpu/evals/zero_shot_text.py`):

    python -m leaf_tpu_torch.evals.zero_shot_text --model ViT-L-14 \\
        --pretrained <checkpoint> --dataset synthetic --rho 20

Classify sentences against image-anchored (or caption-anchored) class
embeddings, attack each with the batched Charmer classification attack,
and report clean and adversarial accuracy with a CSV row per sentence.
Quirk kept: this eval scores *without* the caption template, unlike the
in-training eval.  It runs on `--device` (default `cuda`); images are
encoded in fp32 with TF32 off, text in `--precision`.

Against the JAX package, which writes its CSV once at the end of the
run: each chunk's rows are appended as the chunk completes (in the
length-sorted order the chunks run in), and at the end the file is
rewritten atomically in dataset order, the JAX package's final file.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.text import (
    attack_text_charmer_classification_batched)
from leaf_tpu_torch.data.textcls import TextClassificationData
from leaf_tpu_torch.evals.zero_shot import encode_anchor_images
from leaf_tpu_torch.models.clip import CLIP, TextTower
from leaf_tpu_torch.utils.results import ResultsLedger

LOG = logging.getLogger(__name__)

COLUMNS = ["sentence", "original_label", "predicted_label", "adv_sentence",
           "adv_label"]


def class_anchor_features(scorer: CandidateScorer, model: CLIP, tokenizer,
                          textcls: TextClassificationData,
                          label_encoder: str = "image",
                          preprocess=None) -> torch.Tensor:
    """Normalised per-class anchors [K, D] from the anchor images
    (default; un-normalised pixels through `preprocess`) or the class
    captions."""
    if label_encoder == "text":
        return scorer.encode_text(model.text, tokenizer(textcls.captions),
                                  normalize=True)
    return encode_anchor_images(model.visual, model.cfg, textcls, preprocess)


def eval_zero_shot_text(
    scorer: CandidateScorer,
    text: TextTower,
    tokenizer,
    textcls: TextClassificationData,
    label_features,
    rho: int = 20,
    k: int = 1,
    n_test: Optional[int] = None,
    out_csv: Optional[str] = None,
    chunk_size: int = 16,
) -> Dict[str, float]:
    """Clean and adversarial accuracy over `textcls.samples[:n_test]`.

    Chunks are composed in length order: every device buffer of a chunk
    is padded to the chunk's longest sentence, so grouping similar
    lengths keeps them small.  Each sentence's search reads no other row,
    so results do not depend on the composition, and rows are reported
    in dataset order."""
    ledger = ResultsLedger(out_csv, fresh=True, stream=True,
                           columns=COLUMNS) if out_csv else None
    samples = textcls.samples if n_test is None else textcls.samples[:n_test]
    anchors = torch.as_tensor(label_features).float().to(scorer.device)
    order = sorted(range(len(samples)), key=lambda i: len(samples[i]["text"]))
    rows: Dict[int, Dict] = {}
    for c0 in range(0, len(order), chunk_size):
        idx = order[c0:c0 + chunk_size]
        sentences = [samples[i]["text"] for i in idx]
        labels = [samples[i]["label"] for i in idx]
        adv_sentences = attack_text_charmer_classification_batched(
            scorer, text, tokenizer, sentences, anchors, labels, n=rho, k=k,
            vocab=textcls.vocab)
        feats = scorer.encode_text(text, tokenizer(sentences + adv_sentences),
                                   normalize=True)
        preds = (feats.float() @ anchors.T).argmax(-1).cpu().numpy()
        preds = preds.reshape(2, len(idx))
        for j, i in enumerate(idx):
            rows[i] = {"sentence": sentences[j],
                       "original_label": labels[j],
                       "predicted_label": int(preds[0, j]),
                       "adv_sentence": adv_sentences[j],
                       "adv_label": int(preds[1, j])}
            if ledger is not None:
                ledger.append(rows[i])      # on disk as the chunk completes
    n = len(samples)
    if ledger is not None:
        ledger.rows = [rows[i] for i in range(n)]
        ledger.flush()                      # dataset order, atomically
    if n == 0:
        return {"acc": 0.0, "acc_adv": 0.0, "n": 0}
    acc = sum(rows[i]["predicted_label"] == rows[i]["original_label"]
              for i in range(n))
    acc_adv = sum(rows[i]["adv_label"] == rows[i]["original_label"]
                  for i in range(n))
    return {"acc": acc / n, "acc_adv": acc_adv / n, "n": n}


def main(argv=None) -> Dict[str, float]:
    """Command line: zero-shot text classification against class anchors
    (images by default, captions with --label-encoder text) under the
    batched Charmer margin attack; clean and adversarial accuracy, CSV."""
    import argparse

    from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                               local_checkpoint)
    from leaf_tpu_torch.models.preprocess import image_transform

    p = argparse.ArgumentParser("leaf_tpu_torch zero-shot text eval")
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--dataset", default="agnews",
                   help="textcls registry name | 'synthetic'")
    p.add_argument("--label-encoder", default="image",
                   choices=["image", "text"])
    p.add_argument("--rho", type=int, default=20)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--n_test", type=int, default=100)
    p.add_argument("--precision", default="fp32")
    p.add_argument("--output-dir", default="results_zeroshot_text")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    model = create_model(args.model,
                         local_checkpoint(args.pretrained, "--pretrained",
                                          args.model),
                         precision=args.precision, device=args.device,
                         master_weights=True)
    # the anchor images reach `class_anchor_features` un-normalised: it
    # normalises them itself
    preprocess = image_transform(model.cfg.vision.image_size,
                                 do_normalize=False)
    tokenizer = get_tokenizer(args.model)
    scorer = CandidateScorer(model.cfg, model.device)

    if args.dataset == "synthetic":
        from leaf_tpu_torch.evals.textfare import _load_eval_samples
        samples, _ = _load_eval_samples("synthetic", args.n_test)
        textcls = TextClassificationData.from_samples("agnews", samples)
    else:
        from leaf_tpu_torch.data.textcls import get_text_classification_dataset
        if args.n_test is not None and args.n_test <= 0:
            p.error("--n_test must be positive")
        textcls = get_text_classification_dataset(
            args.dataset, n_samples=args.n_test or 1000)

    label_features = class_anchor_features(
        scorer, model.module, tokenizer, textcls,
        label_encoder=args.label_encoder, preprocess=preprocess)
    os.makedirs(args.output_dir, exist_ok=True)
    out_csv = os.path.join(
        args.output_dir,
        f"{args.model.split('/')[-1]}_{textcls.short_name}"
        f"_k{args.k}_rho_{args.rho}_{args.label_encoder}.csv")
    out = eval_zero_shot_text(scorer, model.module.text, tokenizer, textcls,
                              label_features, rho=args.rho, k=args.k,
                              n_test=args.n_test, out_csv=out_csv)
    print(out)
    return out


if __name__ == "__main__":
    main()
