"""The general traffic generator: turns a traffic file's parameters and the
run's seed into the batches a cell's job feeds to the program.

Captions: words drawn by a Zipf law over the BPE vocabulary's whole words
(merge order stands for frequency), a caption's word count from the
file's law (`word_count`).  A pool of batches is drawn with a fixed number
of batches at each context bucket (`bucket_shares`): a batch at bucket b
has one caption whose token length lies in b's range (its word count from
`longest`, where the file gives it) and the others at or below it, and the
buckets follow each other in an order fixed by their counts, so the seed
picks the captions and not the amount of work.  `margin` keeps the edited
candidates of a batch in its bucket (an edit lengthens a caption by a few
tokens at most), the largest bucket too.

Images: uniform pixels in [0, 1], NHWC float32, a pool of host batches.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from portbench.reference.text import tokenizer

BUCKETS = (16, 32, 48, 64, 77)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of a run's seed."""
    return np.random.default_rng([seed, *stream.encode()])


def bucket_of(need: int, margin: int) -> int:
    """The bucket a batch whose longest caption needs `need` tokens is
    assigned to: the smallest that holds `need + margin` (77 at most)."""
    for b in BUCKETS:
        if need + margin <= b:
            return b
    return BUCKETS[-1]


class CaptionSource:
    def __init__(self, spec: dict, rng: np.random.Generator):
        tok = tokenizer()
        words = tok.whole_words()[:spec["vocab_words"]]
        weights = 1.0 / np.arange(1, len(words) + 1) ** spec["zipf"]
        self.words = np.array(words)
        self.p = weights / weights.sum()
        self.spec = spec
        self.rng = rng
        self.tok = tok
        self.drawn = np.zeros(0, np.int64)

    def draw_words(self, n: int) -> List[str]:
        """The next `n` words of the stream (drawn in blocks)."""
        if len(self.drawn) < n:
            more = self.rng.choice(len(self.words), size=1 << 16, p=self.p)
            self.drawn = np.concatenate([self.drawn, more])
        out, self.drawn = self.drawn[:n], self.drawn[n:]
        return list(self.words[out])

    def word_count(self, law: str = "word_count") -> int:
        s = self.spec[law]
        if s["law"] == "lognormal":
            n = round(math.exp(self.rng.normal(math.log(s["median"]),
                                               s["sigma"])))
        else:
            n = int(self.rng.integers(s["min"], s["max"] + 1))
        return int(min(max(n, s["min"]), s["max"]))

    def caption(self, lo: int, hi: int, law: str = "word_count") -> str:
        """A caption whose token length (SOT to EOT) is in (lo, hi]."""
        while True:
            text = " ".join(self.draw_words(self.word_count(law)))
            if lo < self.tok.length(text) <= hi:
                return text


def caption_pool(spec: dict, seed: int) -> List[List[str]]:
    """`spec["pool_batches"]` batches of `spec["batch"]` captions, with
    `bucket_shares` of them at each bucket, in `interleave`'s order."""
    rng = rng_for(seed, "captions")
    source = CaptionSource(spec["captions"], rng)
    margin = spec["captions"]["margin"]
    longest = "longest" if "longest" in spec["captions"] else "word_count"
    counts = shares_to_counts(spec["bucket_shares"], spec["pool_batches"])
    pool = []
    for b in interleave(counts):
        prev = max([x for x in BUCKETS if x < b], default=0)
        hi = b - margin
        lo = prev - margin if prev else 0
        rows = [source.caption(lo, hi, longest)]
        rows += [source.caption(0, hi) for _ in range(spec["batch"] - 1)]
        rng.shuffle(rows)
        pool.append(rows)
    return pool


def interleave(counts: Dict[int, int]) -> List[int]:
    """The buckets in an order fixed by their counts alone, each spread
    evenly over the pool, so that every stretch of the pool holds about
    the shares of the whole and no seed changes how much work a window
    holds."""
    total = sum(counts.values())
    done = {b: 0 for b in counts}
    order = []
    for _ in range(total):
        b = min(sorted(counts), key=lambda b: (done[b] + 0.5) / counts[b]
                if counts[b] else float("inf"))
        done[b] += 1
        order.append(b)
    return order


def shares_to_counts(shares: Dict[str, float], total: int) -> Dict[int, int]:
    """Batches per bucket: each share of `total`, rounded so that they sum
    to `total` (the largest remainders round up)."""
    exact = {int(b): s * total for b, s in shares.items()}
    counts = {b: int(x) for b, x in exact.items()}
    left = total - sum(counts.values())
    for b in sorted(exact, key=lambda b: exact[b] - counts[b],
                    reverse=True)[:left]:
        counts[b] += 1
    return counts


def image_pool(spec: dict, seed: int) -> List[np.ndarray]:
    rng = rng_for(seed, "images")
    shape = (spec["batch"], spec["image_size"], spec["image_size"], 3)
    return [rng.random(shape, dtype=np.float32)
            for _ in range(spec["pool_batches"])]
