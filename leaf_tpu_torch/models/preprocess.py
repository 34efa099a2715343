"""Host-side image preprocessing: resize, center crop, normalize, and the
contrastive trainer's augmentation (port of `leaf_tpu/models/preprocess.py`,
eval geometry "shortest").

Returns NHWC float32 numpy ready for upload.  The train transform
(`train_image_transform`) is the JAX package's: a random resized crop
(torchvision's 10 attempts and centre-crop fallback, numpy draws from one
generator per decode thread) resized bicubically, then optionally colour
jitter and gray scale, each written in numpy to give Pillow's pixels:
`ImageEnhance`'s Brightness, Contrast and Color are Pillow's `blend` in
float32, hue shifts go through Pillow's HSV conversions, and gray is its
integer `L`.  The card machine has no
Pillow, so the bicubic resize is numpy's own: Pillow's 8-bit
`Image.resize(BICUBIC)` step for step (`resample_bicubic`).  Pillow is
needed only to decode a JPEG/PNG file or byte string (`pil_image`,
`read_image`); `.npy` uint8 arrays need nothing.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple

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



class AugmentationCfg:
    """Train-time augmentation knobs (`--aug-cfg key=value ...`): crop
    `scale` and `ratio` ranges, colour jitter and gray-scale
    probabilities.  Unknown keys raise."""

    def __init__(self, scale=(0.9, 1.0), ratio=(3 / 4, 4 / 3),
                 color_jitter=None, color_jitter_prob=None,
                 gray_scale_prob=None):
        self.scale = tuple(float(s) for s in scale)
        self.ratio = tuple(float(r) for r in ratio)
        self.color_jitter = (tuple(float(c) for c in color_jitter)
                             if color_jitter is not None else None)
        self.color_jitter_prob = color_jitter_prob
        self.gray_scale_prob = gray_scale_prob

    @classmethod
    def parse(cls, d) -> "AugmentationCfg":
        if d is None:
            return cls()
        if isinstance(d, cls):
            return d
        return cls(**d)


def crop_box(w: int, h: int, scale, ratio, rng) -> Tuple[int, int, int, int]:
    """A random resized crop's (left, top, right, bottom) in a w x h image:
    up to 10 draws of an area share in `scale` and a log-uniform aspect
    ratio in `ratio`, then the centre crop of the clipped aspect ratio."""
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return left, top, left + cw, top + ch
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return left, top, left + cw, top + ch


def to_grayscale(arr: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> gray [H, W, 3] uint8, as Pillow's
    `convert("L").convert("RGB")`: L = (19595 R + 38470 G + 7471 B +
    2^15) >> 16."""
    return np.repeat(_luma(arr)[..., None], 3, axis=-1)


def _blend(degenerate: np.ndarray, arr: np.ndarray,
           factor: float) -> np.ndarray:
    """Pillow's `Image.blend(degenerate, arr, factor)` of uint8 arrays:
    degenerate + factor * (arr - degenerate) in float32, clipped to
    [0, 255] and truncated."""
    d = degenerate.astype(np.float32)
    out = d + np.float32(factor) * (arr.astype(np.float32) - d)
    return np.clip(out, 0, 255).astype(np.uint8)


def _luma(arr: np.ndarray) -> np.ndarray:
    rgb = arr.astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> Pillow's 8-bit HSV (`convert("HSV")`), with
    its float and double steps."""
    rgb = arr.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc, minc = rgb.max(-1), rgb.min(-1)
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.maximum(maxc, 1).astype(np.float32)
    rc, gc, bc = ((maxc - c).astype(np.float32) / cr for c in (r, g, b))
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc, 2.0 + rc.astype(np.float64) - bc,
                          4.0 + gc.astype(np.float64) - rc)).astype(np.float32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    return np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc],
                    -1).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's 8-bit HSV -> RGB (`convert("RGB")` of an "HSV" image)."""
    h, s, v = (hsv[..., k].astype(np.int64) for k in range(3))
    x = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(x).astype(np.int64)
    f = (x - i).astype(np.float32)
    fs = (s.astype(np.float64) / 255.0).astype(np.float32)
    vf = v.astype(np.float64)

    def rounded(y):   # C's round(): half away from zero, y >= 0 here
        return np.clip(np.floor(y + 0.5).astype(np.int64), 0, 255)

    p = rounded(vf * (1.0 - fs.astype(np.float64)))
    q = rounded(vf * (1.0 - (fs * f).astype(np.float64)))
    t = rounded(vf * (1.0 - fs.astype(np.float64) * (1.0 - f.astype(
        np.float64))))
    k = i % 6
    rgb = np.stack([np.choose(k, [v, q, p, p, t, v]),
                    np.choose(k, [t, v, v, q, p, p]),
                    np.choose(k, [p, p, t, v, v, q])], -1)
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(np.uint8)


def color_jitter(arr: np.ndarray, cj, prob: float, rng) -> np.ndarray:
    """With probability `prob`, brightness, contrast and saturation factors
    drawn from [max(0, 1 - v), 1 + v] and a hue shift from [-hue, hue] of
    the circle (`cj` = (b, c, s, hue)), applied in that order as Pillow's
    `ImageEnhance` and HSV do."""
    if rng.uniform() >= prob:
        return arr
    b, c, s, hue = cj
    for v, degenerate in (
            (b, lambda a: np.zeros_like(a)),
            (c, lambda a: np.full_like(
                a, int(_luma(a).astype(np.int64).sum() / (a.size // 3)
                       + 0.5))),
            (s, lambda a: np.repeat(_luma(a)[..., None], 3, axis=-1))):
        if v:
            arr = _blend(degenerate(arr), arr,
                         rng.uniform(max(0.0, 1 - v), 1 + v))
    if hue:
        hsv = rgb_to_hsv(arr).astype(np.int16)
        shift = int(round(rng.uniform(-hue, hue) * 255))
        hsv[..., 0] = (hsv[..., 0] + shift) % 256
        arr = hsv_to_rgb(hsv.astype(np.uint8))
    return arr


def train_image_transform(image_size: int, do_normalize: bool = True,
                          mean: Optional[Sequence[float]] = None,
                          std: Optional[Sequence[float]] = None,
                          aug_cfg=None, interpolation: str = "bicubic",
                          seed: int = 0, rank: int = 0):
    """Return fn: PIL image / uint8 array -> NHWC float32 [image_size,
    image_size, 3]: `crop_box` resized bicubically to `image_size`,
    `color_jitter` with `color_jitter_prob`, gray scale with
    `gray_scale_prob`, [0, 1], then (optionally) normalize.  Each thread that calls it draws from its own
    `np.random.default_rng((seed, rank, thread number))`, the threads
    numbered in the order of their first call."""
    aug = AugmentationCfg.parse(aug_cfg)
    if interpolation != "bicubic":
        raise NotImplementedError(
            f"interpolation {interpolation!r} (--image-interpolation) is not "
            "ported to leaf_tpu_torch yet: ROADMAP Queue 1 item 11")
    if aug.color_jitter_prob and (aug.color_jitter is None
                                  or len(aug.color_jitter) != 4):
        raise ValueError("color_jitter_prob needs color_jitter=(b, c, s, "
                         "hue)")
    mean = OPENAI_DATASET_MEAN if mean is None else tuple(mean)
    std = OPENAI_DATASET_STD if std is None else tuple(std)
    local = threading.local()
    threads = [0]
    lock = threading.Lock()

    def _rng():
        rng = getattr(local, "rng", None)
        if rng is None:
            with lock:
                tid = threads[0]
                threads[0] += 1
            rng = local.rng = np.random.default_rng((seed, rank, tid))
        return rng

    def transform(img) -> np.ndarray:
        rng = _rng()
        arr = to_rgb_uint8(img)
        left, top, right, bottom = crop_box(arr.shape[1], arr.shape[0],
                                            aug.scale, aug.ratio, rng)
        arr = resample_bicubic(arr[top:bottom, left:right],
                               (image_size, image_size))
        if aug.color_jitter_prob:
            arr = color_jitter(arr, aug.color_jitter, aug.color_jitter_prob,
                               rng)
        if aug.gray_scale_prob and rng.uniform() < aug.gray_scale_prob:
            arr = to_grayscale(arr)
        arr = arr.astype(np.float32) / 255.0
        return normalize(arr, mean, std) if do_normalize else arr

    return transform
