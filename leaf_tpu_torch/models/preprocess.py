"""Host-side image preprocessing: resize, center crop, normalize (port of
`leaf_tpu/models/preprocess.py`, eval geometry "shortest").

Returns NHWC float32 numpy ready for upload.  The card machine has no
Pillow, so the bicubic resize is numpy's own: Pillow's 8-bit
`Image.resize(BICUBIC)` step for step (`resample_bicubic`).  Pillow is
needed only to decode a JPEG/PNG file or byte string (`pil_image`,
`read_image`); `.npy` uint8 arrays need nothing.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

# Pillow's fixed point for 8-bit resampling (libImaging/Resample.c)
_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_A = -0.5
_BICUBIC_SUPPORT = 2.0


def pil_image():
    """`PIL.Image`, or an ImportError that says what needs it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding a JPEG/PNG image needs Pillow, which is not installed; "
            "give the images as .npy arrays (HWC uint8) instead") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """An image file -> HWC uint8 RGB: `.npy` arrays with numpy, other
    formats with Pillow."""
    if path.lower().endswith(".npy"):
        return to_rgb_uint8(np.load(path))
    with pil_image().open(path) as img:
        return np.asarray(img.convert("RGB"))


def to_rgb_uint8(img) -> np.ndarray:
    """A PIL image or a uint8 array ([H, W], [H, W, 1], [H, W, 3] or
    [H, W, 4]) -> [H, W, 3] uint8, as Pillow's `convert("RGB")`."""
    if not isinstance(img, np.ndarray):
        return np.asarray(img.convert("RGB"))
    if img.dtype != np.uint8:
        raise TypeError(f"image arrays must be uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4):
        raise ValueError(f"expected an [H, W(, 1|3|4)] image, got {img.shape}")
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    return img[..., :3]


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = _BICUBIC_A
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for one axis:
    (first input index [out], fixed-point weights [out, ksize])."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale   # widened when shrinking
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = _bicubic_filter((x[None] + xmin[:, None] - center[:, None] + 0.5)
                        * (1.0 / filterscale))
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]          # summed in order, as in C
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.trunc(w * (1 << _PRECISION_BITS)
                 + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return xmin, k


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` (0: rows, 1: columns) of an [H, W, C] uint8
    array, with Pillow's rounding and clipping to uint8."""
    in_size = arr.shape[axis]
    xmin, k = _coefficients(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None], in_size - 1)
    src = np.moveaxis(arr, axis, 0).astype(np.int64)   # [in, other, C]
    acc = np.einsum("okxc,ok->oxc", src[idx], k) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resample_bicubic(arr: np.ndarray, size) -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for `size` = (w, h): what
    Pillow's `Image.resize(size, BICUBIC)` gives, horizontal pass first
    (each pass skipped where its side keeps its length)."""
    w, h = size
    if w != arr.shape[1]:
        arr = _resample_axis(arr, w, 1)
    if h != arr.shape[0]:
        arr = _resample_axis(arr, h, 0)
    return arr


def resize_shorter(arr: np.ndarray, size: int) -> np.ndarray:
    """Bicubic resize of an [H, W, C] uint8 array's shorter side to
    `size`; an array whose shorter side is `size` already is returned as
    it is."""
    h, w = arr.shape[:2]
    if w < h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return resample_bicubic(arr, new)


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


def image_transform(image_size: int, do_normalize: bool = True,
                    mean: Optional[Sequence[float]] = None,
                    std: Optional[Sequence[float]] = None,
                    interpolation: str = "bicubic",
                    resize_mode: str = "shortest"):
    """Return fn: PIL image / uint8 array -> NHWC float32 [H, W, 3]: the
    shorter side resized to `image_size` (bicubic), center crop, scale to
    [0, 1], then (optionally) normalize with `mean`/`std` (default: the
    OpenAI CLIP statistics).  'random' interpolation is bicubic at eval,
    as in the JAX package; the other interpolations and resize modes are
    not ported."""
    if resize_mode != "shortest":
        raise NotImplementedError(
            f"resize_mode {resize_mode!r} (--image-resize-mode) is not ported "
            "to leaf_tpu_torch yet: ROADMAP Queue 1 item 11")
    if interpolation not in ("bicubic", "random"):
        raise NotImplementedError(
            f"interpolation {interpolation!r} (--image-interpolation) is not "
            "ported to leaf_tpu_torch yet: ROADMAP Queue 1 item 11")
    mean = OPENAI_DATASET_MEAN if mean is None else tuple(mean)
    std = OPENAI_DATASET_STD if std is None else tuple(std)

    def transform(img) -> np.ndarray:
        arr = resize_shorter(to_rgb_uint8(img), image_size)
        arr = center_crop(arr.astype(np.float32) / 255.0, image_size)
        return normalize(arr, mean, std) if do_normalize else arr

    return transform

