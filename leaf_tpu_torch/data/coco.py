"""COCO Karpathy-split retrieval dataset (port of `leaf_tpu/data/coco.py`).

A Karpathy-split JSON annotation file (entries {'image': path,
'caption': [str, ...]}) or a Kaggle flickr `captions.txt`, with captions
cleaned by `evals.retrieval.pre_caption` (at most 50 words) and the
image <-> text positive-pair maps that `evaluate_scores` reads.

Images are read as the ImageNet folder reader reads them
(`models.preprocess.read_image`): pre-decoded `.npy` HWC uint8 arrays
need nothing; an encoded image (JPEG, PNG) needs Pillow, imported only
to open it.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from leaf_tpu_torch.data.common import Prefetcher
from leaf_tpu_torch.models.preprocess import read_image


def load_retrieval_annotations(annotation_file: str):
    """Read retrieval annotations into the Karpathy-JSON structure
    `[{"image": ..., "caption": [...]}, ...]`.

    Accepts the Karpathy JSON itself or the Kaggle flickr30k/flickr8k
    `captions.txt` format: a header line, then `img.jpg,caption` rows,
    several per image (split on ".jpg," because captions can contain
    commas)."""
    if annotation_file.endswith(".json"):
        with open(annotation_file) as f:
            return json.load(f)
    by_image: Dict[str, List[str]] = {}
    order: List[str] = []
    skipped = 0
    with open(annotation_file) as f:
        f.readline()                      # header
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ".jpg," not in line:
                skipped += 1              # .png names / malformed rows
                continue
            img, caption = line.split(".jpg,", 1)
            img = img + ".jpg"
            if img not in by_image:
                by_image[img] = []
                order.append(img)
            by_image[img].append(caption)
    if not order:
        raise ValueError(
            f"{annotation_file!r}: no 'img.jpg,caption' rows parsed "
            f"({skipped} non-matching lines): not a Kaggle flickr "
            "captions.txt?")
    if skipped:
        logging.getLogger(__name__).warning(
            "%s: skipped %d lines without '.jpg,' (non-jpg image names "
            "or malformed rows)", annotation_file, skipped)
    return [{"image": img, "caption": by_image[img]} for img in order]


class CocoRetrievalDataset:
    def __init__(self, root_dir: str, annotation_file: str,
                 image_preprocess: Optional[Callable] = None,
                 max_words: int = 50, num_samples: int = -1,
                 batch_size: int = 25):
        from leaf_tpu_torch.evals.retrieval import pre_caption
        annotation = load_retrieval_annotations(annotation_file)
        if num_samples and num_samples > 0:
            annotation = annotation[:num_samples]
        self.root_dir = root_dir
        self.image_preprocess = image_preprocess
        self.batch_size = batch_size

        self.image: List[str] = []
        self.text: List[str] = []
        self.img2txt: Dict[int, List[int]] = {}
        self.txt2img: Dict[int, int] = {}
        txt_id = 0
        for img_id, ann in enumerate(annotation):
            self.image.append(ann["image"])
            self.img2txt[img_id] = []
            for caption in ann["caption"]:
                self.text.append(pre_caption(caption, max_words))
                self.img2txt[img_id].append(txt_id)
                self.txt2img[txt_id] = img_id
                txt_id += 1

    def __len__(self):
        return len(self.image)

    @property
    def num_batches(self) -> int:
        return -(-len(self.image) // self.batch_size)

    def image_batches(self):
        """Yield image batches in dataset order: HWC uint8 RGB arrays
        through `image_preprocess`, or the arrays themselves without one
        (then all images must share a size)."""

        def gen():
            for b in range(self.num_batches):
                paths = self.image[b * self.batch_size:
                                   (b + 1) * self.batch_size]
                imgs = []
                for p in paths:
                    img = read_image(os.path.join(self.root_dir, p))
                    imgs.append(self.image_preprocess(img)
                                if self.image_preprocess else img)
                yield np.stack(imgs)

        return iter(Prefetcher(gen()))


def get_coco_retrieval(root_dir: str, annotation_file: str, preprocess,
                       num_samples: int = -1,
                       batch_size: int = 25) -> CocoRetrievalDataset:
    return CocoRetrievalDataset(root_dir, annotation_file, preprocess,
                                num_samples=num_samples,
                                batch_size=batch_size)
