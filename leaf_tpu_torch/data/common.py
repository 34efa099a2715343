"""Shared data-pipeline plumbing (port of `leaf_tpu/data/common.py`;
only `DataInfo` so far)."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class DataInfo:
    """A batch iterable with its sizes."""
    loader: Any
    num_batches: int = 0
    num_samples: int = 0

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)
