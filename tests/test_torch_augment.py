"""leaf_tpu_torch's train-time image augmentation against the JAX package's
(Pillow) on seeded arrays: the random resized crop's boxes (draws, the 10
attempts, the centre-crop fallback), Pillow's gray scale, `ImageEnhance`
and HSV conversions pixel for pixel, and the whole transform (with colour
jitter) within one uint8 level."""
import numpy as np
import pytest
from PIL import Image, ImageEnhance

from leaf_tpu.models import preprocess as jpre
from leaf_tpu_torch.models import preprocess as tpre


class _Box:
    """Stands in for a PIL image in JAX's `_random_resized_crop`: records
    the crop box it is given."""

    def __init__(self, w, h, boxes):
        self.size = (w, h)
        self.boxes = boxes

    def crop(self, box):
        self.boxes.append(box)
        return self

    def resize(self, size, interp):
        return self


@pytest.mark.parametrize("w, h, scale, ratio", [
    (256, 256, (0.9, 1.0), (3 / 4, 4 / 3)),      # the default cfg
    (300, 200, (0.08, 1.0), (3 / 4, 4 / 3)),     # torchvision's default
    (256, 64, (2.0, 3.0), (3 / 4, 4 / 3)),       # no attempt fits: wide
    (64, 256, (2.0, 3.0), (3 / 4, 4 / 3)),       # and tall fallbacks
    (100, 100, (2.0, 3.0), (3 / 4, 4 / 3)),      # fallback, ratio inside
])
def test_crop_boxes_match_jax(w, h, scale, ratio):
    boxes = []
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        jpre._random_resized_crop(_Box(w, h, boxes), 32, scale, ratio, None,
                                  rng_j)
    got = [tpre.crop_box(w, h, scale, ratio, rng_t) for _ in range(20)]
    assert got == [tuple(b) for b in boxes]
    assert rng_t.integers(1 << 30) == rng_j.integers(1 << 30)


class _Draws:
    """Stands in for a generator whose `uniform` returns given values."""

    def __init__(self, *values):
        self.values = iter(values)

    def uniform(self, *args):
        return next(self.values)


def test_grayscale_is_pillows():
    arr = np.random.default_rng(0).integers(0, 256, (37, 23, 3),
                                            dtype=np.uint8)
    want = np.asarray(Image.fromarray(arr).convert("L").convert("RGB"))
    np.testing.assert_array_equal(tpre.to_grayscale(arr), want)


def test_enhance_and_hsv_are_pillows():
    """Brightness, contrast and saturation at factors inside and outside
    [0, 1] on seeded pixels and the corner colours; RGB -> HSV over a grid
    of the RGB cube, HSV -> RGB over every (h, s) at 52 values."""
    arr = np.random.default_rng(2).integers(0, 256, (60, 50, 3),
                                            dtype=np.uint8)
    arr[0, :6] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                  [0, 0, 255], [10, 10, 10]]
    img = Image.fromarray(arr)
    for f in (0.0, 0.35, 1.0, 1.7):
        for k, enh in enumerate((ImageEnhance.Brightness,
                                 ImageEnhance.Contrast, ImageEnhance.Color)):
            cj = [0.0] * 4
            cj[k] = 1.0
            # the draws: below the probability, then the factor f
            np.testing.assert_array_equal(
                tpre.color_jitter(arr, cj, 1.0, _Draws(0.0, f)),
                np.asarray(enh(img).enhance(f)))
    cube = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                np.arange(0, 256, 5), indexing="ij"),
                    -1).reshape(-1, 1, 3).astype(np.uint8)
    np.testing.assert_array_equal(
        tpre.rgb_to_hsv(cube), np.asarray(Image.fromarray(cube).convert("HSV")))
    np.testing.assert_array_equal(
        tpre.hsv_to_rgb(cube),
        np.asarray(Image.fromarray(cube, "HSV").convert("RGB")))


@pytest.mark.parametrize("aug", [
    None, {"scale": (0.3, 1.0), "gray_scale_prob": 0.5},
    {"scale": (0.08, 1.0), "ratio": (0.5, 2.0)},
    {"color_jitter": (0.4, 0.4, 0.4, 0.1), "color_jitter_prob": 0.8,
     "gray_scale_prob": 0.2}])
def test_train_transform_matches_jax(aug):
    """Both transforms on the same 12 seeded arrays, one thread: the same
    pixels (within one uint8 level), normalised and not."""
    rng = np.random.default_rng(1)
    shapes = [(256, 256), (200, 300), (300, 180), (64, 97)] * 3
    arrays = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in shapes]
    for norm in (False, True):
        jt = jpre.train_image_transform(48, do_normalize=norm, aug_cfg=aug,
                                        seed=3)
        tt = tpre.train_image_transform(48, do_normalize=norm, aug_cfg=aug,
                                        seed=3)
        for a in arrays:
            want, got = jt(a), tt(a)
            assert got.shape == want.shape == (48, 48, 3)
            assert got.dtype == np.float32
            step = (1 / 255) / (min(tpre.OPENAI_DATASET_STD) if norm else 1)
            np.testing.assert_allclose(got, want, atol=step + 1e-6)


def test_augmentation_refusals():
    with pytest.raises(ValueError, match="color_jitter=.b, c, s, hue"):
        tpre.train_image_transform(32, aug_cfg={"color_jitter_prob": 0.8})
    # bilinear and random are ported (tests/test_torch_pretrained.py);
    # an unknown interpolation raises
    with pytest.raises(ValueError, match="interpolation"):
        tpre.train_image_transform(32, interpolation="lanczos")
    with pytest.raises(TypeError):
        tpre.AugmentationCfg.parse({"nope": 1})
    assert tpre.AugmentationCfg.parse(None).scale == (0.9, 1.0)
