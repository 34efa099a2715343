"""Image-caption selection benchmark, SugarCrepe and the like (port of
`leaf_tpu/benchmark/image_caption_selection.py`): each image comes with a
short list of candidate captions whose FIRST entry is the positive; the
accuracy is the share of images whose positive caption scores highest.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from leaf_tpu_torch.benchmark.zeroshot_classification import (
    image_features, text_features, waited)
from leaf_tpu_torch.models.config import CLIPConfig


def evaluate_image_caption_selection(model, cfg: CLIPConfig, tokenizer,
                                     dataset,
                                     seconds: Optional[Dict[str, float]]
                                     = None) -> Dict[str, float]:
    """`dataset` iterates (images [B,H,W,3] in [0,1], caption lists).
    `seconds`, if given, gains the wall seconds of the waits for the
    dataset ("data") and of the encodes ("device")."""
    clock = seconds if seconds is not None else {}
    correct = 0
    total = 0
    for images, caption_lists in waited(dataset, clock):
        t0 = time.perf_counter()
        img_f = image_features(model.visual, cfg, images)
        flat = [c for caps in caption_lists for c in caps]
        txt_f = text_features(model.text, cfg, tokenizer, flat,
                              batch_size=max(len(flat), 1))
        clock["device"] = clock.get("device", 0.0) + time.perf_counter() - t0
        off = 0
        for i, caps in enumerate(caption_lists):
            k = len(caps)
            scores = img_f[i] @ txt_f[off:off + k].T
            # the positive caption is index 0; a strict argmax win counts
            correct += int(np.argmax(scores) == 0)
            total += 1
            off += k
    return {"acc": correct / max(total, 1), "num_samples": total}
