"""ImageFolder-style ImageNet loaders (port of `leaf_tpu/data/imagenet.py`).

Class subdirectories in sorted order give the labels; the train split is
subsampled to 50 images a class, the val split drawn at random down to
`n_val` (the reference evaluates robustness on a 1000-image subset).
Besides the JAX package's image files (decoded with Pillow, imported
where it is used) a folder may hold `.npy` HWC uint8 arrays, which need
nothing but numpy: the card machine has no Pillow.
"""
from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from leaf_tpu_torch.data.common import DataInfo, Prefetcher
from leaf_tpu_torch.models.preprocess import read_image

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")
ARRAY_EXTS = (".npy",)


def list_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """(paths, labels, class_names) with sorted-directory class ids."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for ci, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMG_EXTS + ARRAY_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, classes


class ImageFolderDataset:
    """Batched iterator over an image folder tree: (images [B, H, W, 3]
    through `preprocess`, labels [B])."""

    def __init__(self, root: str, preprocess: Callable, batch_size: int = 64,
                 subsample_per_class: Optional[int] = None,
                 n_random: Optional[int] = None, seed: int = 0,
                 shuffle: bool = False, process_index: int = 0,
                 process_count: int = 1):
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        # multi-host: a disjoint stride of the epoch-shuffled order per
        # host, equal counts (DistributedSampler semantics)
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = -1
        paths, labels, self.classes = list_image_folder(root)
        paths = np.asarray(paths)
        labels = np.asarray(labels)
        rng = np.random.default_rng(seed)
        if subsample_per_class is not None:
            keep = []
            for c in range(len(self.classes)):
                idx = np.where(labels == c)[0]
                keep.append(rng.permutation(idx)[:subsample_per_class])
            keep = np.concatenate(keep)
            paths, labels = paths[keep], labels[keep]
        if n_random is not None and n_random < len(paths):
            keep = rng.choice(len(paths), n_random, replace=False)
            paths, labels = paths[keep], labels[keep]
        self.paths, self.labels = paths, labels

    def __len__(self):
        return len(self.paths)

    @property
    def _local_n(self) -> int:
        return len(self.paths) // self.process_count \
            if self.process_count > 1 else len(self.paths)

    @property
    def num_batches(self) -> int:
        return -(-self._local_n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self.epoch += 1
        order = np.arange(len(self.paths))
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(order)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
            order = order[:self._local_n]

        def batches():
            for b in range(self.num_batches):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                imgs = [self.preprocess(read_image(str(self.paths[i])))
                        for i in idx]
                yield np.stack(imgs), self.labels[idx]

        return iter(Prefetcher(batches()))


def get_imagenet(root: str, preprocess: Callable, split: str = "val",
                 batch_size: int = 64, n_val: Optional[int] = 1000,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1) -> DataInfo:
    if split == "train":
        ds = ImageFolderDataset(root, preprocess, batch_size,
                                subsample_per_class=50, seed=seed,
                                shuffle=True, process_index=process_index,
                                process_count=process_count)
    else:
        ds = ImageFolderDataset(root, preprocess, batch_size,
                                n_random=n_val, seed=seed)
    return DataInfo(ds, num_batches=ds.num_batches, num_samples=len(ds))
