"""Text-classification datasets for the image-anchored zero-shot eval
(port of `leaf_tpu/data/textcls.py`: AG-News, SST-2, IMDB, Yelp).

Each dataset carries its class-anchor images (zero-shot text
classification is image-anchored), caption templates and the character
vocabulary of its training split (the attack vocabulary at eval).  The
anchor images are the JAX package's JPEG/PNG assets decoded once to RGB
uint8 and kept in `models/assets/anchor_images.npz`
(`python -m leaf_tpu_torch.data.anchor_assets` writes it where Pillow
is installed), so the card machine, which has no Pillow, reads them with
numpy.  Loading a dataset from the hub needs the `datasets` package,
imported where it is used; `TextClassificationData.from_samples` builds
one from in-memory samples.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

ANCHOR_NPZ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models", "assets", "anchor_images.npz")

# per-dataset metadata
_REGISTRY = {
    "agnews": dict(
        hf_id="fancyzhx/ag_news", text_key="text",
        test_split="test", val_from_train=True,
        anchor_images=["politics-0.jpeg", "sports-0.jpeg",
                       "business-0.jpeg", "technology-0.jpeg"],
        captions=["World News", "Sports News", "Business News",
                  "Science and Technology News"],
        template="{}",
    ),
    "sst2": dict(
        hf_id="stanfordnlp/sst2", text_key="sentence",
        test_split="validation", val_from_train=True,
        anchor_images=["Negative.png", "Positive.png"],
        captions=["Negative Review", "Positive Review"],
        template="Sentiment: {}",
    ),
    "imdb": dict(
        hf_id="stanfordnlp/imdb", text_key="text",
        test_split="test", val_from_train=False,
        anchor_images=["Negative.png", "Positive.png"],
        captions=["Negative Review", "Positive Review"],
        template="Sentiment: {}",
    ),
    "yelp": dict(
        hf_id="fancyzhx/yelp_polarity", text_key="text",
        # the reference takes the 'test' split for yelp even for the
        # class-balanced test=False subset, unlike agnews and sst2
        test_split="test", val_from_train=False,
        anchor_images=["Negative.png", "Positive.png"],
        captions=["Negative Review", "Positive Review"],
        template="Sentiment: {}",
    ),
}

_HF_TO_SHORT = {v["hf_id"]: k for k, v in _REGISTRY.items()}


@functools.lru_cache()
def _anchor_arrays() -> Dict[str, np.ndarray]:
    with np.load(ANCHOR_NPZ) as f:
        return {name: f[name] for name in f.files}


def char_vocabulary(texts: Sequence[str]) -> List[int]:
    """Attack vocabulary from a corpus: delete (-1) + every character
    appearing in the texts."""
    V = {-1}
    for t in texts:
        V.update(ord(c) for c in set(t))
    return list(V)


@dataclasses.dataclass
class TextClassificationData:
    """Samples + metadata for image-anchored zero-shot text eval."""
    short_name: str
    samples: List[Dict]            # [{'text': str, 'label': int}]
    vocab: List[int]               # attack char vocabulary
    anchor_names: List[str]        # one anchor image per class (asset name)
    captions: List[str]            # one caption per class
    template: str                  # caption template, e.g. 'Sentiment: {}'

    @property
    def num_classes(self) -> int:
        return len(self.captions)

    def anchor_images(self, preprocess) -> np.ndarray:
        """The class anchors through `preprocess`, stacked [K, H, W, 3]."""
        arrays = _anchor_arrays()
        return np.stack([preprocess(arrays[n]) for n in self.anchor_names])

    @classmethod
    def from_samples(cls, name: str, samples: List[Dict],
                     vocab: Optional[List[int]] = None
                     ) -> "TextClassificationData":
        meta = _REGISTRY[name]
        return cls(
            short_name=name,
            samples=samples,
            vocab=vocab or char_vocabulary([s["text"] for s in samples]),
            anchor_names=list(meta["anchor_images"]),
            captions=list(meta["captions"]),
            template=meta["template"],
        )


def get_text_classification_dataset(name: str, n_samples: int = 1000,
                                    test: bool = True
                                    ) -> TextClassificationData:
    """Load through the hub's `datasets` package with the reference's
    split and subset rules: test -> the first n; train (test=False) ->
    the first n/K of each class."""
    name = _HF_TO_SHORT.get(name, name)
    name = {"ag_news": "agnews", "sst-2": "sst2"}.get(name, name)
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown text-classification dataset {name!r}; "
            f"known: {sorted(_REGISTRY)}")
    meta = _REGISTRY[name]
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise ImportError(
            f"loading {meta['hf_id']} needs the `datasets` package, which is "
            "not installed; use --val-text-classification synthetic") from e
    ds = load_dataset(meta["hf_id"])
    text_key = meta["text_key"]

    if name == "imdb":
        split = ds[meta["test_split"]]
        half = n_samples // 2
        idx = list(range(half)) + list(range(len(split) - half, len(split)))
        samples = [{"text": split[i][text_key], "label": split[i]["label"]}
                   for i in idx]
    else:
        split_name = meta["test_split"] if test else "train"
        if not test and not meta["val_from_train"]:
            split_name = meta["test_split"]
        split = ds[split_name]
        if test:
            idx = range(min(n_samples, len(split)))
            samples = [{"text": split[i][text_key], "label": split[i]["label"]}
                       for i in idx]
        else:
            K = len(meta["captions"])
            per = n_samples // K
            counts = [0] * K
            samples = []
            for x in split:
                lab = x["label"]
                if counts[lab] < per:
                    samples.append({"text": x[text_key], "label": lab})
                    counts[lab] += 1
                if sum(counts) >= per * K:
                    break

    vocab = char_vocabulary(x[text_key] for x in ds["train"])
    return TextClassificationData.from_samples(name, samples, vocab)
