"""The traffic generator: a seed fixes the batches, and the traffic file
fixes how many batches sit at each bucket, whatever the seed."""
from __future__ import annotations

import collections
import json
import os

import numpy as np

from portbench import generate
from portbench.jobs.leaf import checked_order
from portbench.reference.text import tokenizer

TRAFFIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def _spec(name, **small):
    with open(os.path.join(TRAFFIC, f"{name}.json")) as f:
        spec = json.load(f)
    spec.update(small)
    return spec


def test_the_seed_fixes_the_captions():
    spec = _spec("ctx77", pool_batches=8, batch=16)
    first = generate.caption_pool(spec, 2 ** 31 + 3)
    assert first == generate.caption_pool(spec, 2 ** 31 + 3)
    assert first != generate.caption_pool(spec, 2 ** 31 + 5)


def test_the_file_fixes_the_batches_at_each_bucket():
    spec = _spec("ctx77", pool_batches=16, batch=24,
                 bucket_shares={"16": 0.25, "32": 0.25, "48": 0.25,
                                "77": 0.25})
    spec["captions"]["longest"] = {"law": "uniform", "min": 1, "max": 71}
    margin = spec["captions"]["margin"]
    tok = tokenizer()
    want = generate.shares_to_counts(spec["bucket_shares"], 16)
    order = generate.interleave(want)
    for seed in (1, 2 ** 33 + 1):
        pool = generate.caption_pool(spec, seed)
        got = [generate.bucket_of(max(tok.length(c) for c in batch), margin)
               for batch in pool]
        assert got == order
        assert collections.Counter(got) == want


def test_the_buckets_are_spread_over_the_pool():
    counts = generate.shares_to_counts({"48": 0.4375, "64": 0.4375,
                                        "77": 0.125}, 64)
    assert counts == {48: 28, 64: 28, 77: 8}
    order = generate.interleave(counts)
    for n in range(1, len(order) + 1):
        seen = collections.Counter(order[:n])
        for b, c in counts.items():
            assert abs(seen[b] - c * n / 64) <= 1


def test_the_checked_steps_take_every_bucket_of_the_pool():
    order = generate.interleave(generate.shares_to_counts(
        {"48": 0.4375, "64": 0.4375, "77": 0.125}, 64))
    assert order[:3] == [48, 64, 48] and order.index(77) > 3
    checked, rest = checked_order(order, 3)
    assert checked == [0, 1, order.index(77)]
    assert sorted(checked + rest) == list(range(64))
    assert checked_order([16] * 8, 3) == ([0, 1, 2], [3, 4, 5, 6, 7])
    assert checked_order([16, 32, 48, 77, 16], 3)[0] == [0, 1, 2, 3]


def test_one_caption_a_batch_fills_the_full_context():
    spec = _spec("ctx77", pool_batches=4, batch=32)
    tok = tokenizer()
    margin = spec["captions"]["margin"]
    for batch in generate.caption_pool(spec, 2 ** 33 + 7):
        lengths = sorted(tok.length(c) for c in batch)
        assert 64 - margin < lengths[-1] <= 77 - margin
        assert lengths[-2] <= 16 - margin
        words = sorted(len(c.split()) for c in batch)
        assert 59 <= words[-1] <= 71 and 3 <= words[0] and words[-2] <= 10


def test_short_captions_stay_in_bucket_16():
    spec = _spec("short", pool_batches=4, batch=32)
    tok = tokenizer()
    for batch in generate.caption_pool(spec, 9):
        assert all(3 <= len(c.split()) <= 10 for c in batch)
        longest = max(tok.length(c) for c in batch)
        assert longest <= 16 - spec["captions"]["margin"]


def test_the_seed_fixes_the_images():
    spec = _spec("pgd10", pool_batches=2, batch=2, image_size=28)
    a, b = generate.image_pool(spec, 7), generate.image_pool(spec, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2, 28, 28, 3) and a[0].dtype == np.float32
    assert 0.0 <= a[0].min() and a[0].max() < 1.0
    assert not np.array_equal(a[0], generate.image_pool(spec, 8)[0])
