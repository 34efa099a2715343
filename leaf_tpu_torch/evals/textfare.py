"""TextFARE evaluation inputs (port of `leaf_tpu/evals/textfare.py`).

Only `_load_eval_samples` so far, which the trainer's
`--val-text-classification synthetic` path shares; `eval_textfare` and
its command line come with the attacks they call (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def _load_eval_samples(dataset: str, n_test: Optional[int]):
    """'synthetic', a JSON file of [{'text': ...}, ...] (or of strings),
    or a text-classification registry name (needs the `datasets`
    package) -> (samples, attack vocabulary or None)."""
    if dataset == "synthetic":
        rng = np.random.default_rng(0)
        words = ("stocks rally market team won cup government policy "
                 "tech chip ancient fossil film review great terrible").split()
        return [{"text": " ".join(rng.choice(words, size=8)), "label": 0}
                for _ in range(n_test or 16)], None
    if os.path.exists(dataset):
        with open(dataset) as f:
            data = json.load(f)
        return [{"text": d} if isinstance(d, str) else d for d in data], None
    from leaf_tpu_torch.data.textcls import get_text_classification_dataset
    data = get_text_classification_dataset(dataset, n_samples=n_test or 1000)
    # the reference attacks with the dataset's train-split character
    # vocabulary, not the generic ASCII set
    return data.samples, data.vocab
