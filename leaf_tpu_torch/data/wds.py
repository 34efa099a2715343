"""Webdataset-style tar pipeline in plain Python (port of
`leaf_tpu/data/wds.py`; no webdataset package).

Brace-expanded tar shard lists, a deterministic shard shuffle per epoch,
a per-host shard split, sample grouping that skips corrupt members, a
streaming sample shuffle and equal-batch rounding across hosts.  Batches
are (images [B, H, W, 3] float32 NHWC or None, texts list[str]): raw
text, tokenized by the training process.  The LEAF trainer is text-only
and reads captions alone (`text_only`), so an image is never decoded on
its path.  Beyond the JAX package's image members (JPEG, PNG, WebP,
decoded with Pillow, imported where it is used), a sample's image may be
an `.npy` HWC uint8 array, which needs no Pillow.
"""
from __future__ import annotations

import collections
import io
import logging
import math
import random
import re
import subprocess
import tarfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from leaf_tpu_torch.data.common import DataInfo, Prefetcher, bucket_for, shuffle_buffer
from leaf_tpu_torch.models.preprocess import pil_image, to_rgb_uint8

LOG = logging.getLogger(__name__)

SAMPLE_SHUFFLE_SIZE = 5000
SAMPLE_SHUFFLE_INITIAL = 1000

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "npy")
_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")
_ALT_RE = re.compile(r"\{([^{}.]*(?:,[^{}.]*)+)\}")


def expand_urls(urls) -> List[str]:
    """Expand `prefix-{0000..0099}.tar` brace notation and `::`-joined
    lists; lists pass through.  Several brace groups in one url expand to
    their cartesian product, left-most group first, like the braceexpand
    package (`shard_{000..009}_{000..009}.tar` -> 100 urls)."""
    if isinstance(urls, str):
        urls = urls.split("::")
    out: List[str] = []
    for url in urls:
        m = _BRACE_RE.search(url)
        a = _ALT_RE.search(url)
        if m and a:
            if m.start() < a.start():
                a = None
            else:
                m = None
        if m:
            lo, hi = m.group(1), m.group(2)
            width = len(lo)
            for i in range(int(lo), int(hi) + 1):
                out.extend(expand_urls(
                    [url[:m.start()] + str(i).zfill(width) + url[m.end():]]))
        elif a:  # {train,val} comma alternation
            for part in a.group(1).split(","):
                out.extend(expand_urls(
                    [url[:a.start()] + part + url[a.end():]]))
        else:
            out.append(url)
    return out


def expand_urls_with_weights(urls, weights):
    """Per-source weights expanded to per-shard: each `::`-joined
    source's weight is repeated for every shard its brace notation
    expands to."""
    if weights is None:
        return expand_urls(urls), None
    if isinstance(urls, str):
        urls = urls.split("::")
    if isinstance(weights, str):
        weights = weights.split("::")
    weights = [float(w) for w in weights]
    if len(weights) != len(urls):
        raise ValueError(
            f"expected one upsampling factor per data source "
            f"({len(urls)}), got {len(weights)}")
    all_urls: List[str] = []
    all_weights: List[float] = []
    for url, w in zip(urls, weights):
        shards = expand_urls(url)
        all_urls.extend(shards)
        all_weights.extend([w] * len(shards))
    return all_urls, all_weights


def base_plus_ext(path: str) -> Tuple[Optional[str], Optional[str]]:
    """Split 'dir/xyz.ext' -> ('dir/xyz', 'ext'); None for dotfiles."""
    m = re.match(r"^((?:.*/)?.+?)\.([^/]*)$", path)
    if not m:
        return None, None
    return m.group(1), m.group(2)


class _PipeTar:
    """tarfile over a `pipe:` subprocess; close() reaps the process and
    logs a non-zero exit (a failed `aws s3 cp` would otherwise look like
    an empty shard)."""

    def __init__(self, cmd: str):
        self._cmd = cmd
        self._proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        try:
            self._tar = tarfile.open(fileobj=self._proc.stdout, mode="r|*")
        except BaseException:
            # reap even when the stream is unreadable from the start
            self._proc.stdout.close()
            self._proc.wait()
            raise

    def __iter__(self):
        return iter(self._tar)

    def extractfile(self, member):
        return self._tar.extractfile(member)

    def close(self):
        self._tar.close()
        self._proc.stdout.close()
        rc = self._proc.wait()
        if rc != 0:
            LOG.warning("pipe shard command failed (exit %d): %s", rc, self._cmd)


def _open_tar(url: str):
    """A local file, a `pipe:cmd` subprocess stream, or an http(s)
    stream: the url schemes webdataset accepts."""
    if url.startswith("pipe:"):
        return _PipeTar(url[5:])
    if url.startswith(("http://", "https://")):
        import urllib.request
        return tarfile.open(fileobj=urllib.request.urlopen(url), mode="r|*")
    return tarfile.open(url, "r")


def iter_tar_samples(path: str) -> Iterator[dict]:
    """Group a tar's members into samples by key prefix; an unreadable
    shard or a corrupt member is logged and skipped, never raised."""
    try:
        tf = _open_tar(path)
    except (OSError, EOFError, tarfile.TarError) as e:
        LOG.warning("skipping unreadable shard %s (%r)", path, e)
        return
    current: Optional[dict] = None
    try:
        for member in tf:
            if not member.isfile():
                continue
            prefix, suffix = base_plus_ext(member.name)
            if prefix is None:
                continue
            suffix = suffix.lower()
            try:
                data = tf.extractfile(member).read()
            except (OSError, EOFError, tarfile.TarError) as e:
                LOG.warning("skipping corrupt member %s (%r)", member.name, e)
                continue
            if current is None or prefix != current["__key__"] \
                    or suffix in current:
                if current is not None and len(current) > 2:
                    yield current
                current = {"__key__": prefix, "__url__": path}
            current[suffix] = data
        if current is not None and len(current) > 2:
            yield current
    finally:
        tf.close()


def decode_sample(sample: dict, preprocess: Optional[Callable],
                  text_only: bool = False) -> Optional[dict]:
    """txt + image bytes -> {'image': array, 'text': str}; None drops the
    sample (no caption; no image unless `text_only`; undecodable).

    `text_only` never touches the image (the LEAF text-AT loop discards
    images).  Otherwise an `.npy` member is read with numpy and any other
    image is decoded with Pillow, where a machine without Pillow raises:
    it is an error of the setup, not of a sample."""
    if "txt" not in sample:
        return None
    img_bytes = ext = None
    for ext in IMAGE_EXTS:
        if ext in sample:
            img_bytes = sample[ext]
            break
    if img_bytes is None and not text_only:
        # text-only training also accepts caption-only tars
        return None
    Image = None if text_only or ext == "npy" else pil_image()
    try:
        text = sample["txt"].decode("utf-8")
        if text_only:
            return {"image": None, "text": text}
        if Image is None:
            img = to_rgb_uint8(np.load(io.BytesIO(img_bytes)))
        else:
            img = np.asarray(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
        image = preprocess(img) if preprocess else img
    except Exception as e:  # noqa: BLE001 -- a bad sample is skipped
        LOG.warning("skipping undecodable sample %s (%r)",
                    sample.get("__key__"), e)
        return None
    return {"image": image, "text": text}


def parallel_map_ordered(fn: Callable, it: Iterator, workers: int,
                         depth_per_worker: int = 4) -> Iterator:
    """Order-preserving threaded map (image decode releases the GIL)."""
    if workers <= 1:
        yield from map(fn, it)
        return
    depth = workers * depth_per_worker
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futs: collections.deque = collections.deque()
        for item in it:
            try:
                futs.append(ex.submit(fn, item))
            except RuntimeError:
                # the executor shuts down mid-epoch (the consumer left)
                return
            if len(futs) >= depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


@dataclass
class WdsConfig:
    urls: str | Sequence[str]
    batch_size: int = 64
    is_train: bool = True
    seed: int = 0
    num_samples: Optional[int] = None
    resampled: bool = False
    upsampling_factors: Optional[Sequence[float]] = None
    process_index: int = 0
    process_count: int = 1
    sample_shuffle_size: int = SAMPLE_SHUFFLE_SIZE
    sample_shuffle_initial: int = SAMPLE_SHUFFLE_INITIAL
    text_only: bool = False   # skip image decode (LEAF text-AT)
    workers: int = 4          # decode threads (`--workers`)
    # length-bucketed batches (`--bucket-by-length`): captions of similar
    # token length share a batch, so that the fused attack's per-batch
    # context bucket stays small on long-tailed alt-text streams
    bucket_by_length: bool = False
    length_fn: Optional[Callable[[str], int]] = None
    length_buckets: Optional[Sequence[int]] = None


class WdsDataset:
    """Epoch-aware iterable over (images, texts) batches."""

    def __init__(self, cfg: WdsConfig, preprocess: Optional[Callable] = None):
        self.cfg = cfg
        self.preprocess = preprocess
        self.epoch = -1
        self.urls, self.shard_weights = expand_urls_with_weights(
            cfg.urls, cfg.upsampling_factors)
        if self.shard_weights is not None and not cfg.resampled:
            raise ValueError(
                "upsampling factors are only supported when sampling with "
                "replacement (--dataset-resampled)")
        if cfg.is_train and not cfg.resampled \
                and len(self.urls) < cfg.process_count:
            raise ValueError("number of shards must be >= number of hosts")

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _shards_for_epoch(self, epoch: int, pass_: int = 0) -> List[str]:
        # pass_ > 0 is a rollover inside the epoch (equal-batch rounding
        # runs the dataset again): it reshuffles, it does not replay
        cfg = self.cfg
        epoch = epoch + 100003 * pass_
        if cfg.resampled:
            # shards drawn with replacement, optionally weighted
            rng = random.Random(cfg.seed + epoch + 1000003 * cfg.process_index)
            k = max(1, len(self.urls))
            if self.shard_weights is not None:
                return rng.choices(self.urls, weights=self.shard_weights, k=k)
            return [rng.choice(self.urls) for _ in range(k)]
        urls = list(self.urls)
        if cfg.is_train:
            # the same permutation on every host, then disjoint strides
            rng = random.Random(cfg.seed + epoch)
            rng.shuffle(urls)
            urls = urls[cfg.process_index::cfg.process_count]
        return urls

    def _samples(self, epoch: int, pass_: int = 0) -> Iterator[dict]:
        rng = random.Random(self.cfg.seed + epoch + 100003 * pass_
                            + 31 * self.cfg.process_index)

        def raw():
            for url in self._shards_for_epoch(epoch, pass_):
                yield from iter_tar_samples(url)

        # shuffle the raw byte samples and decode after: decoded float
        # images would hold ~12x the memory
        it = raw()
        if self.cfg.is_train:
            it = shuffle_buffer(it, self.cfg.sample_shuffle_size,
                                self.cfg.sample_shuffle_initial, rng)

        def decode(s):
            return decode_sample(s, self.preprocess, self.cfg.text_only)

        decoded = parallel_map_ordered(
            decode, it, 1 if self.cfg.text_only else self.cfg.workers)
        return (d for d in decoded if d is not None)

    def __iter__(self):
        self.epoch += 1
        epoch = self.epoch
        cfg = self.cfg
        target = self.num_batches if cfg.is_train else None

        def stack(images):
            return None if cfg.text_only else np.stack(images)

        if cfg.bucket_by_length:
            if cfg.length_fn is None:
                raise ValueError("bucket_by_length requires length_fn")
            from leaf_tpu_torch.attacks.engine import CONTEXT_BUCKETS
            bounds = sorted(cfg.length_buckets or CONTEXT_BUCKETS)
        else:
            bounds = [0]  # one accumulator: plain batching
        buckets = {b: ([], []) for b in bounds}

        def route(s):
            if not cfg.bucket_by_length:
                return buckets[0]
            return buckets[bucket_for(cfg.length_fn(s["text"]), bounds)]

        def pending():
            return sum(len(t) for _, t in buckets.values())

        def batches():
            produced = 0
            pass_ = 0
            while target is None or produced < target:
                n_before = produced
                for s in self._samples(epoch, pass_):
                    images, texts = route(s)
                    images.append(s["image"])
                    texts.append(s["text"])
                    if len(texts) == cfg.batch_size:
                        yield stack(images), list(texts)
                        images.clear()
                        texts.clear()
                        produced += 1
                        if target is not None and produced >= target:
                            return
                if target is None:
                    # eval: flush the leftovers longest bucket first, in
                    # (possibly mixed, possibly partial) batches
                    left_i = [im for b in reversed(bounds)
                              for im in buckets[b][0]]
                    left_t = [t for b in reversed(bounds)
                              for t in buckets[b][1]]
                    for i in range(0, len(left_t), cfg.batch_size):
                        yield (stack(left_i[i:i + cfg.batch_size]),
                               left_t[i:i + cfg.batch_size])
                    return
                if produced == n_before and not pending():
                    # a whole pass gave nothing: returning fewer than
                    # `target` batches would leave the other hosts of a
                    # multi-host run waiting at the next collective
                    raise RuntimeError(
                        f"train shard slice for host "
                        f"{cfg.process_index}/{cfg.process_count} "
                        f"produced no samples on pass {pass_} "
                        f"({len(self.urls)} shards total); cannot fill "
                        f"{target} batches of {cfg.batch_size}")
                # train: roll over the dataset to fill the fixed batch count
                pass_ += 1

        return iter(Prefetcher(batches()))

    @property
    def num_samples(self) -> int:
        if self.cfg.num_samples is not None:
            return self.cfg.num_samples
        raise RuntimeError("the number of training samples must be given "
                           "(--train-num-samples)")

    @property
    def num_batches(self) -> int:
        cfg = self.cfg
        global_batch = cfg.batch_size * cfg.process_count
        return max(1, math.ceil(self.num_samples / global_batch))


def get_wds_dataset(cfg: WdsConfig, preprocess=None) -> DataInfo:
    ds = WdsDataset(cfg, preprocess)
    if cfg.is_train:
        nb = ds.num_batches
        return DataInfo(ds, num_batches=nb,
                        num_samples=nb * cfg.batch_size * cfg.process_count)
    return DataInfo(ds, num_samples=cfg.num_samples or 0)
