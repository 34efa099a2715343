"""Zero-shot retrieval benchmark (port of
`leaf_tpu/benchmark/zeroshot_retrieval.py`): image <-> text recall@K over
a dataset where each image has one or more captions.

Features are normalised and brought to the host in fp32; the towers
compute in their weights' dtype, with TF32 off; captions are encoded
`batch_size` at a time at their length bucket.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from leaf_tpu_torch.benchmark.zeroshot_classification import (
    image_features, text_features, waited)
from leaf_tpu_torch.models.config import CLIPConfig


def recall_at_k(scores: np.ndarray, positive_pairs: np.ndarray,
                k: int) -> np.ndarray:
    """Per-query recall@k: the fraction of a query's positives in its
    top-k."""
    topk = np.argsort(-scores, axis=1)[:, :k]
    hits = np.take_along_axis(positive_pairs, topk, axis=1).sum(1)
    n_pos = positive_pairs.sum(1)
    return hits / np.maximum(n_pos, 1)


def evaluate_zeroshot_retrieval(
    model,
    cfg: CLIPConfig,
    tokenizer,
    image_loader,                 # yields image batches [B,H,W,3] in [0,1]
    captions: Sequence[str],
    img2txt: Dict[int, List[int]],
    recall_ks: Sequence[int] = (1, 5, 10),
    batch_size: int = 256,
    seconds: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Recall@k both ways for the `CLIP` module `model`.  `seconds`, if
    given, gains the wall seconds of the waits for the loader ("data"),
    the image encodes ("images") and the caption encodes ("texts")."""
    clock = seconds if seconds is not None else {}
    img_feats = []
    for images in waited(image_loader, clock):
        t0 = time.perf_counter()
        img_feats.append(image_features(model.visual, cfg, images))
        clock["images"] = clock.get("images", 0.0) + time.perf_counter() - t0
    image_embs = np.concatenate(img_feats, 0)
    t0 = time.perf_counter()
    text_embs = text_features(model.text, cfg, tokenizer, captions,
                              batch_size)
    clock["texts"] = clock.get("texts", 0.0) + time.perf_counter() - t0

    positive = np.zeros((len(image_embs), len(text_embs)), bool)
    for img_id, txt_ids in img2txt.items():
        for t in txt_ids:
            positive[img_id, t] = True

    scores_i2t = image_embs @ text_embs.T
    out = {}
    for k in recall_ks:
        out[f"image_retrieval_recall@{k}"] = float(
            (recall_at_k(scores_i2t.T, positive.T, k) > 0).mean())
        out[f"text_retrieval_recall@{k}"] = float(
            (recall_at_k(scores_i2t, positive, k) > 0).mean())
    return out
