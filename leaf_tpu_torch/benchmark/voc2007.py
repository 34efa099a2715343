"""PASCAL VOC 2007 as a classification benchmark (port of
`leaf_tpu/benchmark/voc2007.py`), in two variants:

  * **voc2007**: every annotated bounding box is one sample, cropped from
    its image and labelled with its object category (single label);
  * **voc2007_multilabel**: whole images with a 20-dim 0/1 target vector,
    evaluated with the mean average precision.

Reads the devkit layout under the root,
`VOCdevkit/VOC2007/{JPEGImages,Annotations,ImageSets/Main}`; there is no
download.  Items are HWC uint8 arrays: a JPEG is decoded by
`models.preprocess.read_image` (Pillow, imported where a file is opened),
a `.npy` array beside it in `JPEGImages/` needs nothing.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List, Tuple

import numpy as np

from leaf_tpu_torch.benchmark.tv_datasets import crop
from leaf_tpu_torch.models.preprocess import read_image

OBJECT_CATEGORIES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
_CAT_IDX = {c: i for i, c in enumerate(OBJECT_CATEGORIES)}


def _voc_dir(root: str) -> str:
    d = os.path.join(root, "VOCdevkit", "VOC2007")
    if not os.path.isdir(d):
        raise FileNotFoundError(
            f"voc2007: expected the devkit layout at {d} (there is no "
            "download)")
    return d


def read_split(root: str, split: str) -> List[str]:
    path = os.path.join(_voc_dir(root), "ImageSets", "Main", f"{split}.txt")
    with open(path) as f:
        return [l.split()[0] for l in f if l.strip()]


def read_objects(root: str, image_id: str
                 ) -> List[Tuple[int, Tuple[int, int, int, int], bool]]:
    """[(category index, (left, top, right, bottom), difficult), ...]."""
    xml = ET.parse(os.path.join(_voc_dir(root), "Annotations",
                                image_id + ".xml"))
    out = []
    for obj in xml.findall("object"):
        c = _CAT_IDX[obj.find("name").text]
        bb = obj.find("bndbox")
        box = tuple(int(float(bb.find(k).text))
                    for k in ("xmin", "ymin", "xmax", "ymax"))
        diff = obj.find("difficult")
        out.append((c, box, diff is not None and diff.text.strip() == "1"))
    return out


def _image(root: str, image_id: str) -> np.ndarray:
    base = os.path.join(_voc_dir(root), "JPEGImages", image_id)
    return read_image(base + ".npy" if os.path.exists(base + ".npy")
                      else base + ".jpg")


class Voc2007Cropped:
    """One sample per annotated bounding box."""

    def __init__(self, root: str, split: str = "test"):
        self.root = root
        self.classes = list(OBJECT_CATEGORIES)
        self.samples = []
        for image_id in read_split(root, split):
            for label, box, _ in read_objects(root, image_id):
                self.samples.append((image_id, box, label))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        image_id, box, label = self.samples[i]
        return crop(_image(self.root, image_id), box), label


class Voc2007Multilabel:
    """Whole images with 20-dim 0/1 targets; every box counts, difficult
    ones too, as in the reference."""

    def __init__(self, root: str, split: str = "test"):
        self.root = root
        self.classes = list(OBJECT_CATEGORIES)
        self.samples = []
        for image_id in read_split(root, split):
            target = np.zeros(len(OBJECT_CATEGORIES), np.float32)
            for label, _, _difficult in read_objects(root, image_id):
                target[label] = 1.0
            self.samples.append((image_id, target))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        image_id, target = self.samples[i]
        return _image(self.root, image_id), target
