"""Synthetic dataset: black images and a fixed caption (port of
`leaf_tpu/data/synthetic.py`).

The no-data backend of the trainer's smoke runs.
"""
from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np

from leaf_tpu_torch.data.common import DataInfo


class SyntheticDataset:
    def __init__(self, dataset_size: int = 100, image_size: int = 224,
                 caption: str = "Dummy caption", batch_size: int = 16,
                 seed: int = 0, drop_last: bool = True,
                 preprocess: Optional[Callable] = None):
        self.dataset_size = dataset_size
        self.batch_size = batch_size
        self.caption = caption
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = -1
        # the black image, through `preprocess` where one is given
        black = np.zeros((image_size, image_size, 3), np.uint8)
        self.image = (preprocess(black) if preprocess is not None
                      else black.astype(np.float32))

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self.dataset_size // self.batch_size
        return -(-self.dataset_size // self.batch_size)

    def __iter__(self):
        self.epoch += 1
        order = list(range(self.dataset_size))
        random.Random(self.seed + self.epoch).shuffle(order)
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            # every image is the same black one: a read-only view, no copy
            images = np.broadcast_to(self.image,
                                     (len(idx),) + self.image.shape)
            texts = [self.caption] * len(idx)
            yield images, texts


def get_synthetic_dataset(dataset_size: int, batch_size: int,
                          image_size: int = 224, seed: int = 0,
                          preprocess: Optional[Callable] = None) -> DataInfo:
    ds = SyntheticDataset(dataset_size, image_size, batch_size=batch_size,
                          seed=seed, preprocess=preprocess)
    return DataInfo(ds, num_batches=ds.num_batches, num_samples=dataset_size)
