"""The zero-shot classifier and its metadata (port of
`leaf_tpu/models/zero_shot.py`).

For every class, encode all templated prompts, average the normalised
embeddings, normalise again, and stack into a [D, K] classifier, a few
classes per encode call.  The 1000 ImageNet class names and the 80
OpenAI prompt templates are read from the port's own copy of the JSON
asset, `leaf_tpu_torch/models/assets/zero_shot_metadata.json`.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from leaf_tpu_torch.models.clip import l2_normalize

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                      "zero_shot_metadata.json")


@functools.lru_cache()
def _metadata() -> dict:
    with open(_ASSET) as f:
        return json.load(f)


def imagenet_classnames() -> List[str]:
    return list(_metadata()["imagenet_classnames"])


def openai_imagenet_templates() -> List[str]:
    """80 prompt templates as '{}'-format strings."""
    return list(_metadata()["openai_imagenet_templates"])


def simple_imagenet_templates() -> List[str]:
    return list(_metadata()["simple_imagenet_templates"])


def build_zero_shot_classifier(
    encode_text: Callable[[np.ndarray], torch.Tensor],
    tokenizer,
    classnames: Sequence[str],
    templates: Sequence[Union[str, Callable[[str], str]]],
    num_classes_per_batch: Optional[int] = 10,
) -> torch.Tensor:
    """Build a [D, K] float32 zero-shot classifier on the encoder's device.

    encode_text: fn(tokens [N, C]) -> unnormalised features [N, D], in any
    float dtype; templates: '{}'-format strings or callables str -> str.
    """
    fmt = [t if callable(t) else t.format for t in templates]
    T = len(fmt)
    chunks = []
    step = num_classes_per_batch or len(classnames)
    for start in range(0, len(classnames), step):
        batch_names = classnames[start:start + step]
        texts = [f(name) for name in batch_names for f in fmt]
        feats = encode_text(tokenizer(texts)).float()
        feats = l2_normalize(feats.reshape(len(batch_names), T, -1))
        chunks.append(l2_normalize(feats.mean(dim=1)))
    return torch.cat(chunks, dim=0).T  # [D, K]
