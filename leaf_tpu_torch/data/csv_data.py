"""CSV image-caption dataset (port of `leaf_tpu/data/csv_data.py`).

With `text_only` (the LEAF text-AT trainer, which discards images) the
image files are never opened and batches carry `None` for images;
otherwise each image goes through `models.preprocess.read_image` (`.npy`
arrays with numpy, other files with Pillow) and `preprocess`.
"""
from __future__ import annotations

import csv
import os
import random
from typing import Callable, Optional

import numpy as np

from leaf_tpu_torch.data.common import DataInfo, Prefetcher
from leaf_tpu_torch.models.preprocess import read_image


class CsvDataset:
    def __init__(self, filename: str, preprocess: Optional[Callable],
                 img_key: str = "filepath", caption_key: str = "title",
                 sep: str = "\t", batch_size: int = 64, seed: int = 0,
                 shuffle: bool = False, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 text_only: bool = False):
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        # training drops the final partial batch (equal-batch rounding)
        self.drop_last = drop_last
        # multi-host: each host reads a disjoint stride of the (epoch-
        # shuffled) index list, DistributedSampler semantics
        self.process_index = process_index
        self.process_count = process_count
        self.text_only = text_only
        self.epoch = -1
        self.root = os.path.dirname(os.path.abspath(filename))
        with open(filename, newline="") as f:
            rows = list(csv.DictReader(f, delimiter=sep))
        self.images = [r[img_key] for r in rows]
        self.captions = [r[caption_key] for r in rows]

    def __len__(self):
        return len(self.images)

    @property
    def _local_n(self) -> int:
        # every host gets the same count; the tail is dropped
        return len(self.images) // self.process_count \
            if self.process_count > 1 else len(self.images)

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self._local_n // self.batch_size
        return -(-self._local_n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _image(self, i: int) -> np.ndarray:
        p = self.images[i]
        if not os.path.isabs(p):
            p = os.path.join(self.root, p)
        return self.preprocess(read_image(p))

    def __iter__(self):
        self.epoch += 1
        order = list(range(len(self.images)))
        if self.shuffle:
            # the same permutation on every host, then disjoint strides
            random.Random(self.seed + self.epoch).shuffle(order)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
            order = order[:self._local_n]

        def batches():
            for b in range(self.num_batches):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                images = None if self.text_only else np.stack(
                    [self._image(i) for i in idx])
                yield images, [self.captions[i] for i in idx]

        return iter(Prefetcher(batches()))


def get_csv_dataset(filename: str, preprocess, batch_size: int = 64,
                    img_key: str = "filepath", caption_key: str = "title",
                    sep: str = "\t", shuffle: bool = False,
                    seed: int = 0, drop_last: bool = False,
                    process_index: int = 0, process_count: int = 1,
                    text_only: bool = False) -> DataInfo:
    ds = CsvDataset(filename, preprocess, img_key, caption_key, sep,
                    batch_size, seed, shuffle, drop_last,
                    process_index=process_index, process_count=process_count,
                    text_only=text_only)
    return DataInfo(ds, num_batches=ds.num_batches, num_samples=len(ds))
