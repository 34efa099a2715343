"""Write `models/assets/anchor_images.npz`: the JAX package's six class
anchor images (`leaf_tpu/models/assets/*.jpeg|png`, read by path)
decoded to RGB uint8 at their own sizes, so that the text-classification
eval reads them without Pillow.  Needs Pillow:

    python -m leaf_tpu_torch.data.anchor_assets
"""
from __future__ import annotations

import os

import numpy as np

from leaf_tpu_torch.data.textcls import ANCHOR_NPZ, _REGISTRY
from leaf_tpu_torch.models.preprocess import read_image

SOURCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "leaf_tpu", "models", "assets")


def anchor_names():
    """Every anchor asset the registry names, sorted."""
    return sorted({n for meta in _REGISTRY.values()
                   for n in meta["anchor_images"]})


def decode_sources() -> dict:
    return {n: read_image(os.path.join(SOURCE_DIR, n)) for n in anchor_names()}


def main() -> None:
    arrays = decode_sources()
    np.savez_compressed(ANCHOR_NPZ, **arrays)
    for name, a in arrays.items():
        print(f"{name}: {a.shape} {a.dtype}")
    print(f"wrote {ANCHOR_NPZ} ({os.path.getsize(ANCHOR_NPZ)} bytes)")


if __name__ == "__main__":
    main()
