"""Context-length bucketing of token buffers (port of the numpy helpers
in `leaf_tpu/attacks/engine.py`).

With a causal mask and argmax-EOT pooling, tokens after the EOT position
cannot influence the pooled feature, so slicing the [., 77] buffer down
to the smallest bucket >= max(EOT)+1 is exact: same features, a fraction
of the work.  The candidate scoring engine comes with a later slice.
"""
from __future__ import annotations

import numpy as np

CONTEXT_BUCKETS = (16, 32, 48, 64, 77)


def bucket_tokens(tokens, buckets=CONTEXT_BUCKETS, need=None):
    """Slice a [..., C] token buffer to the smallest safe bucket.

    `need` overrides the locally computed max(EOT)+1."""
    arr = np.asarray(tokens)
    if need is None:
        need = int(arr.argmax(-1).max()) + 1  # EOT is the max id per row
    for b in buckets:
        if need <= b <= arr.shape[-1]:
            return arr[..., :b]
    return arr


def bucket_need(tokens) -> int:
    """The bucket requirement of a token buffer: max(EOT)+1."""
    return int(np.asarray(tokens).argmax(-1).max()) + 1


def can_bucket(cfg) -> bool:
    """Bucketing is feature-invariant only for causal towers with
    argmax-EOT pooling.  `cfg` is a CLIPConfig."""
    return (not cfg.text.no_causal_mask) and cfg.text.pool_type == "argmax"
