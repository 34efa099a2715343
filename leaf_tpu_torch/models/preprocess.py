"""Host-side image preprocessing: resize, center crop, normalize, and the
contrastive trainer's augmentation (port of `leaf_tpu/models/preprocess.py`).
The eval geometry is the JAX package's three `resize_mode`s (shortest side
resized then centre-cropped, longest side fitted then zero-padded, squash
to the square) with its interpolations (bicubic, bilinear, and random:
bicubic at eval, a draw of either per image at train time).

Returns NHWC float32 numpy ready for upload.  The train transform
(`train_image_transform`) is the JAX package's: a random resized crop
(torchvision's 10 attempts and centre-crop fallback, numpy draws from one
generator per decode thread) resized bicubically, then optionally colour
jitter and gray scale, each written in numpy to give Pillow's pixels:
`ImageEnhance`'s Brightness, Contrast and Color are Pillow's `blend` in
float32, hue shifts go through Pillow's HSV conversions, and gray is its
integer `L`.  The card machine has no
Pillow, so the resize is numpy's own: Pillow's 8-bit `Image.resize` with
its BICUBIC or BILINEAR filter step for step (`resample`).  Pillow is
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


def _bilinear_filter(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# Pillow's filters: (function, support)
FILTERS = {"bicubic": (_bicubic_filter, 2.0),
           "bilinear": (_bilinear_filter, 1.0)}


def _coefficients(in_size: int, out_size: int, filt: str = "bicubic"):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for one axis:
    (first input index [out], fixed-point weights [out, ksize])."""
    fn, base_support = FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale   # widened when shrinking
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = fn((x[None] + xmin[:, None] - center[:, None] + 0.5)
           * (1.0 / filterscale))
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]          # summed in order, as in C
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.trunc(w * (1 << _PRECISION_BITS)
                 + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return xmin, k


def _resample_axis(arr: np.ndarray, out_size: int, axis: int,
                   filt: str = "bicubic") -> np.ndarray:
    """One pass along `axis` (0: rows, 1: columns) of an [H, W, C] uint8
    array, with Pillow's rounding and clipping to uint8."""
    in_size = arr.shape[axis]
    xmin, k = _coefficients(in_size, out_size, filt)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None], in_size - 1)
    src = np.moveaxis(arr, axis, 0).astype(np.int64)   # [in, other, C]
    acc = np.einsum("okxc,ok->oxc", src[idx], k) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resample(arr: np.ndarray, size, filt: str = "bicubic") -> np.ndarray:
    """[H, W, C] uint8 -> [h, w, C] uint8 for `size` = (w, h): what
    Pillow's `Image.resize(size, BICUBIC | BILINEAR)` gives, horizontal
    pass first (each pass skipped where its side keeps its length)."""
    w, h = size
    if w != arr.shape[1]:
        arr = _resample_axis(arr, w, 1, filt)
    if h != arr.shape[0]:
        arr = _resample_axis(arr, h, 0, filt)
    return arr


def resample_bicubic(arr: np.ndarray, size) -> np.ndarray:
    """`resample` with Pillow's BICUBIC filter."""
    return resample(arr, size, "bicubic")


def resize_shorter(arr: np.ndarray, size: int,
                   filt: str = "bicubic") -> np.ndarray:
    """Resize of an [H, W, C] uint8 array's shorter side to `size`; an
    array whose shorter side is `size` already is returned as it is."""
    h, w = arr.shape[:2]
    if w < h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return resample(arr, new, filt)


RESIZE_MODES = ("shortest", "longest", "squash")
INTERPOLATIONS = ("bicubic", "bilinear", "random")


def _interp(interpolation: str, rng=None) -> str:
    """The filter of an interpolation: 'random' draws bicubic or bilinear
    from `rng` (the JAX package's draw)."""
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r}; "
                         f"expected one of {INTERPOLATIONS}")
    if interpolation == "random":
        idx = int(rng.integers(2)) if rng is not None \
            else np.random.randint(2)
        return ("bicubic", "bilinear")[idx]
    return interpolation


def geometry(arr: np.ndarray, image_size: int, resize_mode: str,
             filt: str = "bicubic") -> np.ndarray:
    """The eval geometry of an [H, W, 3] uint8 array -> [image_size,
    image_size, 3] float32 in [0, 1]: 'shortest' resizes the shorter side
    and centre-crops, 'longest' fits the longer side and zero-pads around
    the centre, 'squash' resizes to the square."""
    h, w = arr.shape[:2]
    if resize_mode == "squash":
        return resample(arr, (image_size, image_size), filt) \
            .astype(np.float32) / 255.0
    if resize_mode == "longest":
        scale = image_size / max(w, h)
        nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
        fit = resample(arr, (nw, nh), filt).astype(np.float32) / 255.0
        out = np.zeros((image_size, image_size, 3), np.float32)
        top, left = (image_size - nh) // 2, (image_size - nw) // 2
        out[top:top + nh, left:left + nw] = fit
        return out
    if resize_mode != "shortest":
        raise ValueError(f"unknown resize_mode {resize_mode!r}; expected "
                         f"one of {RESIZE_MODES}")
    arr = resize_shorter(arr, image_size, filt)
    return center_crop(arr.astype(np.float32) / 255.0, image_size)


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
    `resize_mode` geometry (`geometry`) with `interpolation` ('random' is
    bicubic at eval, as in the JAX package), scaled to [0, 1], then
    (optionally) normalized with `mean`/`std` (default: the OpenAI CLIP
    statistics)."""
    filt = "bicubic" if interpolation == "random" else _interp(interpolation)
    if resize_mode not in RESIZE_MODES:
        raise ValueError(f"unknown resize_mode {resize_mode!r}; expected "
                         f"one of {RESIZE_MODES}")
    mean = OPENAI_DATASET_MEAN if mean is None else tuple(mean)
    std = OPENAI_DATASET_STD if std is None else tuple(std)

    def transform(img) -> np.ndarray:
        arr = geometry(to_rgb_uint8(img), image_size, resize_mode, filt)
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
    image_size, 3]: `crop_box` resized to `image_size` with
    `interpolation` ('random' draws bicubic or bilinear per image first),
    `color_jitter` with `color_jitter_prob`, gray scale with
    `gray_scale_prob`, [0, 1], then (optionally) normalize.  Each thread that calls it draws from its own
    `np.random.default_rng((seed, rank, thread number))`, the threads
    numbered in the order of their first call."""
    aug = AugmentationCfg.parse(aug_cfg)
    _interp(interpolation, np.random.default_rng(0))     # refuse unknowns
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
        filt = _interp(interpolation, rng)
        left, top, right, bottom = crop_box(arr.shape[1], arr.shape[0],
                                            aug.scale, aug.ratio, rng)
        arr = resample(arr[top:bottom, left:right],
                       (image_size, image_size), filt)
        if aug.color_jitter_prob:
            arr = color_jitter(arr, aug.color_jitter, aug.color_jitter_prob,
                               rng)
        if aug.gray_scale_prob and rng.uniform() < aug.gray_scale_prob:
            arr = to_grayscale(arr)
        arr = arr.astype(np.float32) / 255.0
        return normalize(arr, mean, std) if do_normalize else arr

    return transform
