"""Host-side image preprocessing: resize, center crop, normalize (port of
`leaf_tpu/models/preprocess.py`).

Returns NHWC float32 numpy ready for upload.  Pillow is imported only
where an image is decoded or resized, so importing this module (and the
text half of serving) needs no Pillow.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_shorter(img, size: int):
    """PIL bicubic resize of the shorter side to `size`."""
    from PIL import Image
    w, h = img.size
    if w < h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return img.resize(new, Image.BICUBIC)


def center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top:top + size, left:left + size]


def normalize(images: np.ndarray,
              mean: Sequence[float] = OPENAI_DATASET_MEAN,
              std: Sequence[float] = OPENAI_DATASET_STD) -> np.ndarray:
    """[..., H, W, 3] in [0,1] -> normalized (broadcast over batch)."""
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    return (images - mean) / std


def image_transform(image_size: int):
    """Return fn: PIL image / uint8 array -> NHWC float32 [H, W, 3]: the
    eval pipeline of the JAX package's defaults (shorter side resized to
    `image_size` with bicubic filtering, center crop, scale to [0, 1],
    normalize with the OpenAI CLIP statistics)."""

    def transform(img) -> np.ndarray:
        from PIL import Image
        if isinstance(img, np.ndarray):
            img = Image.fromarray(img)
        img = resize_shorter(img.convert("RGB"), image_size)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return normalize(center_crop(arr, image_size))

    return transform
