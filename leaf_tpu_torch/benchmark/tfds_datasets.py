"""Native readers for tfds-layout (TFRecord) VTAB datasets (port of
`leaf_tpu/benchmark/tfds_datasets.py`).

Reads the on-disk layout of tensorflow_datasets,
`<root>/<tfds_name>/<version>/<name>-<split>.tfrecord-NNNNN-of-NNNNN`,
with no tensorflow:

  * TFRecord framing (length + masked crc32c + payload) in pure Python,
    crc-checked, and a writer of the same framing;
  * a minimal `tf.train.Example` protobuf codec (parse and encode);
  * the VTAB label derivations of the structured datasets, as
    task_adaptation's preprocess functions compute them;
  * the VTAB split carving for datasets without a native test split
    (percent sub-splits of the tfds train split, in record order).

Only the features each task needs are read; an image is decoded when its
batch is made: encoded bytes (PNG, JPEG) with Pillow, imported there, and
an `.npy` payload with numpy.  Items are HWC uint8 arrays.
"""
from __future__ import annotations

import dataclasses
import glob
import io
import json
import os
import re
import struct
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from leaf_tpu_torch.data.common import Prefetcher
from leaf_tpu_torch.models.preprocess import pil_image, to_rgb_uint8

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — TFRecord framing checksums
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def iter_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one .tfrecord file.

    `verify_crc` checks the length crc always (cheap, catches framing
    corruption) and the payload crc when True — the payload check is a
    pure-Python byte loop, so large image datasets should pass False
    (the dataset classes below do)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return
            (length,), (lcrc,) = struct.unpack("<Q", head[:8]), \
                struct.unpack("<I", head[8:])
            if _masked_crc(head[:8]) != lcrc:
                raise IOError(f"{path}: corrupt length crc")
            data = f.read(length)
            dcrc = struct.unpack("<I", f.read(4))[0]
            if verify_crc and _masked_crc(data) != dcrc:
                raise IOError(f"{path}: corrupt record crc")
            yield data


def count_tfrecords(path: str) -> int:
    """Record count via frame-header seeks (payload bytes untouched)."""
    n = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if len(head) < 12:
                return n
            (length,), (lcrc,) = struct.unpack("<Q", head[:8]), \
                struct.unpack("<I", head[8:])
            if _masked_crc(head[:8]) != lcrc:
                raise IOError(f"{path}: corrupt length crc")
            f.seek(length + 4, os.SEEK_CUR)
            n += 1


def write_tfrecord(path: str, records: Sequence[bytes]) -> None:
    """Write records with valid masked-crc framing (conversion/tests)."""
    with open(path, "wb") as f:
        for rec in records:
            head = struct.pack("<Q", len(rec))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


# ---------------------------------------------------------------------------
# Minimal tf.train.Example protobuf codec
# ---------------------------------------------------------------------------
# Wire schema (tensorflow/core/example/{example,feature}.proto):
#   Example    { Features features = 1; }
#   Features   { map<string, Feature> feature = 1; }
#   Feature    { BytesList bytes_list = 1; FloatList float_list = 2;
#                Int64List int64_list = 3; }  (oneof)
#   BytesList  { repeated bytes value = 1; }
#   FloatList  { repeated float value = 1 [packed]; }
#   Int64List  { repeated int64 value = 1 [packed]; }

def _read_varint(buf: bytes, i: int):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterator:
    """Yield (field_number, wire_type, value) over a message buffer."""
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, i = _read_varint(buf, i)
        elif wtype == 1:
            val = buf[i:i + 8]
            i += 8
        elif wtype == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wtype == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def parse_example(record: bytes) -> Dict[str, list]:
    """tf.train.Example bytes → {feature name: list of values}.

    bytes features → list[bytes]; float features → list[float]; int64
    features → list[int]."""
    out: Dict[str, list] = {}
    for fnum, _, features_buf in _fields(record):
        if fnum != 1:
            continue
        for fnum2, _, entry in _fields(features_buf):
            if fnum2 != 1:
                continue
            key, feature = None, b""
            for fnum3, _, v in _fields(entry):
                if fnum3 == 1:
                    key = v.decode("utf-8")
                elif fnum3 == 2:
                    feature = v
            if key is None:
                continue
            values: list = []
            for kind, _, lst in _fields(feature):
                for f4, w4, v4 in _fields(lst):
                    if f4 != 1:
                        continue
                    if kind == 1:              # bytes
                        values.append(v4)
                    elif kind == 2:            # float
                        if w4 == 2:            # packed
                            values.extend(
                                struct.unpack(f"<{len(v4) // 4}f", v4))
                        else:
                            values.append(struct.unpack("<f", v4)[0])
                    elif kind == 3:            # int64
                        if w4 == 2:            # packed varints
                            i = 0
                            while i < len(v4):
                                x, i = _read_varint(v4, i)
                                values.append(_signed(x))
                        else:
                            values.append(_signed(v4))
            out[key] = values
    return out


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def _varint(x: int) -> bytes:
    if x < 0:
        x += 1 << 64
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tagged(fnum: int, wtype: int, payload: bytes) -> bytes:
    tag = _varint(fnum << 3 | wtype)
    if wtype == 2:
        return tag + _varint(len(payload)) + payload
    return tag + payload


def encode_example(features: Dict[str, list]) -> bytes:
    """{name: list of bytes/float/int} → tf.train.Example bytes."""
    entries = b""
    for key, values in features.items():
        if values and isinstance(values[0], (bytes, bytearray)):
            lst = b"".join(_tagged(1, 2, bytes(v)) for v in values)
            feature = _tagged(1, 2, lst)
        elif values and isinstance(values[0], float):
            packed = struct.pack(f"<{len(values)}f", *values)
            feature = _tagged(2, 2, _tagged(1, 2, packed))
        else:
            packed = b"".join(_varint(int(v)) for v in values)
            feature = _tagged(3, 2, _tagged(1, 2, packed))
        entry = _tagged(1, 2, key.encode("utf-8")) + _tagged(2, 2, feature)
        entries += _tagged(1, 2, entry)
    return _tagged(1, 2, entries)


# ---------------------------------------------------------------------------
# Dataset directory / split resolution
# ---------------------------------------------------------------------------

_SLICE_RE = re.compile(r"^(\w+)(?:\[([0-9]+%?)?:([0-9]+%?)?\])?$")


def parse_split_spec(split_spec: str):
    """'train' / 'train[80%:]' / 'test[:50%]' / 'train[800:]' →
    (base, lo, hi) where lo/hi are (value, is_percent) or None —
    tfds sub-split slice syntax, absolute indices included."""
    m = _SLICE_RE.match(split_spec)
    if not m:
        raise ValueError(f"bad split spec {split_spec!r}")

    def bound(s):
        if s is None:
            return None
        if s.endswith("%"):
            return (int(s[:-1]), True)
        return (int(s), False)

    return m.group(1), bound(m.group(2)), bound(m.group(3))


def _resolve_bound(b, n: int, default: int) -> int:
    if b is None:
        return default
    value, is_pct = b
    if is_pct:
        # tfds percent slicing rounds to CLOSEST (round-half-up), not
        # floor — a floor at the boundary shifts the carve by one record
        return int(value * n / 100 + 0.5)
    return min(value, n)


def find_tfds_dir(root: str, tfds_name: str) -> Optional[str]:
    """Locate the version dir holding the tfrecord shards.

    Accepts `root` = the version dir itself, the tfds_name dir, a tfds
    data_dir containing `<tfds_name>/<version>/`, or a builder-config
    layout `<tfds_name>/<config>/<version>/` (e.g.
    diabetic_retinopathy_detection/btgraham-300/3.0.0).  A bare
    `<root>/*` is only searched when `root` itself is named after the
    dataset — matching an arbitrary sibling dataset's shards would
    silently evaluate the wrong data."""
    cands = [root]
    cands += sorted(glob.glob(os.path.join(root, tfds_name, "*")))
    cands += sorted(glob.glob(os.path.join(root, tfds_name, "*", "*")))
    base = os.path.basename(os.path.normpath(root))
    if base == tfds_name:
        cands += sorted(glob.glob(os.path.join(root, "*")))
        cands += sorted(glob.glob(os.path.join(root, "*", "*")))
    for c in cands:
        if os.path.isdir(c) and glob.glob(
                os.path.join(c, f"{tfds_name}-*.tfrecord-*")):
            return c
    return None


_COUNT_CACHE: Dict[tuple, int] = {}


def _cached_count(path: str) -> int:
    key = (path, os.path.getmtime(path))
    if key not in _COUNT_CACHE:
        _COUNT_CACHE[key] = count_tfrecords(path)
    return _COUNT_CACHE[key]


def _split_files(d: str, split: str) -> List[str]:
    return sorted(glob.glob(os.path.join(d, f"*-{split}.tfrecord-*")))


def _split_file_list(d: str, split_spec: str):
    """(files, start, stop, total) for a (possibly sliced) split —
    counted via frame-header seeks, payloads untouched."""
    base, lo, hi = parse_split_spec(split_spec)
    files = _split_files(d, base)
    if not files:
        raise FileNotFoundError(
            f"no shards for split {base!r} under {d} (expected "
            f"'*-{base}.tfrecord-NNNNN-of-NNNNN')")
    counts = [_cached_count(f) for f in files]
    n = sum(counts)
    a = _resolve_bound(lo, n, 0)
    b = _resolve_bound(hi, n, n)
    return files, a, b, n


def _skip_records(fh, n: int) -> int:
    """Seek past n records (frame headers only); returns records skipped."""
    done = 0
    while done < n:
        head = fh.read(12)
        if len(head) < 12:
            return done
        (length,) = struct.unpack("<Q", head[:8])
        fh.seek(length + 4, os.SEEK_CUR)
        done += 1
    return done


def iter_split_records(d: str, split_spec: str) -> Iterator[bytes]:
    """Stream a split's records in order, applying tfds-style slice
    bounds — the carving task_adaptation applies to datasets without a
    native test split.  Nothing is held in memory beyond one record;
    whole files below the slice start are skipped by their (cached)
    counts and leading records inside the boundary file are seeked
    past, so a `train[80%:]` test split never reads the 80% of
    payload bytes it does not use."""
    files, a, b, _ = _split_file_list(d, split_spec)
    counts = [_COUNT_CACHE[(f, os.path.getmtime(f))] for f in files]
    i = 0
    for f, cnt in zip(files, counts):
        if i >= b:
            return
        if i + cnt <= a:          # entirely below the slice
            i += cnt
            continue
        with open(f, "rb") as fh:
            if i < a:
                i += _skip_records(fh, a - i)
            while i < b:
                head = fh.read(12)
                if len(head) < 12:
                    break
                (length,) = struct.unpack("<Q", head[:8])
                (lcrc,) = struct.unpack("<I", head[8:])
                if _masked_crc(head[:8]) != lcrc:
                    raise IOError(f"{f}: corrupt length crc")
                data = fh.read(length)
                fh.seek(4, os.SEEK_CUR)
                yield data
                i += 1


def load_split_records(d: str, split_spec: str) -> List[bytes]:
    """Materialised variant of `iter_split_records` (small datasets /
    tests)."""
    return list(iter_split_records(d, split_spec))


# ---------------------------------------------------------------------------
# VTAB task adapters
# ---------------------------------------------------------------------------

def _label_of(key):
    def fn(ex):
        return int(ex[key][0])
    return fn


def _clevr_count_all(ex):
    """task_adaptation/data/clevr.py _count_preprocess_fn:
    label = len(objects) - 3 (scenes hold 3..10 objects)."""
    return len(ex["objects/size"]) - 3


def _clevr_closest_object_distance(ex):
    """task_adaptation/data/clevr.py _closest_object_preprocess_fn:
    dist = min z of objects' pixel_coords; thresholds
    [0, 8, 8.5, 9, 9.5, 10, 100] → 6 classes."""
    z = np.asarray(ex["objects/pixel_coords"], np.float32).reshape(-1, 3)
    dist = float(z[:, 2].min())
    thrs = np.array([0.0, 8.0, 8.5, 9.0, 9.5, 10.0, 100.0])
    return int(np.max(np.nonzero((thrs - dist) < 0)[0]))


def _kitti_closest_vehicle_distance(ex):
    """reference `datasets/kitti.py:_closest_vehicle_distance_pp`:
    vehicles = objects with type < 3 (Car/Van/Truck); dist = min z
    (1000 when none); thresholds [-100, 8, 20, 999] → 4 classes."""
    types = np.asarray(ex.get("objects/type", []), np.int64)
    locs = np.asarray(ex.get("objects/location", []),
                      np.float32).reshape(-1, 3)
    zs = [float(locs[i, 2]) for i in range(len(types)) if types[i] < 3]
    dist = min(zs + [1000.0])
    thrs = np.array([-100.0, 8.0, 20.0, 999.0])
    return int(np.max(np.nonzero((thrs - dist) < 0)[0]))


@dataclasses.dataclass
class VtabSpec:
    tfds_name: str
    label_fn: Callable
    test_split: str                 # task_adaptation tfds_splits['test']
    num_classes: Optional[int] = None
    image_key: str = "image"
    classnames: Optional[Sequence[str]] = None
    # task_adaptation tfds_splits['train'] — carved so it never
    # overlaps the carved test split
    train_split: str = "train"


# tfds resisc45 ClassLabel names (the aerial-scene classes the
# reference's classifier is built over when `classes=None` falls back
# to tfds feature names)
RESISC45_CLASSES = (
    "airplane", "airport", "baseball diamond", "basketball court",
    "beach", "bridge", "chaparral", "church", "circular farmland",
    "cloud", "commercial area", "dense residential", "desert", "forest",
    "freeway", "golf course", "ground track field", "harbor",
    "industrial area", "intersection", "island", "lake", "meadow",
    "medium residential", "mobile home park", "mountain", "overpass",
    "palace", "parking lot", "railway", "railway station",
    "rectangular farmland", "river", "roundabout", "runway", "sea ice",
    "ship", "snowberg", "sparse residential", "stadium", "storage tank",
    "tennis court", "terrace", "thermal power station", "wetland")


# Split carving follows task_adaptation/data/<name>.py (train/val/test
# percentages of datasets without a native test split).
VTAB_TFDS: Dict[str, VtabSpec] = {
    # resisc45 has only a tfds 'train' split; VTAB carves 60/20/20
    "resisc45": VtabSpec("resisc45", _label_of("label"), "train[80%:]", 45,
                         classnames=RESISC45_CLASSES,
                         train_split="train[:60%]"),
    "dmlab": VtabSpec("dmlab", _label_of("label"), "test", 6),
    "pcam": VtabSpec("patch_camelyon", _label_of("label"), "test", 2),
    "diabetic_retinopathy": VtabSpec(
        "diabetic_retinopathy_detection", _label_of("label"), "test", 5),
    "clevr_count_all": VtabSpec("clevr", _clevr_count_all,
                                "validation", 8,
                                train_split="train[:90%]"),
    "clevr_closest_object_distance": VtabSpec(
        "clevr", _clevr_closest_object_distance, "validation", 6,
        train_split="train[:90%]"),
    # dsprites has one 'train' split; VTAB carves 85/5/10
    "dsprites_label_orientation": VtabSpec(
        "dsprites", _label_of("label_orientation"), "train[90%:]", 40,
        train_split="train[:85%]"),
    "dsprites_label_x_position": VtabSpec(
        "dsprites", _label_of("label_x_position"), "train[90%:]", 32,
        train_split="train[:85%]"),
    # smallnorb: VTAB carves val/test as halves of the native tfds
    # 'test' split (task_adaptation smallnorb.py: val='test[:50%]',
    # test='test[50%:]')
    "smallnorb_label_azimuth": VtabSpec(
        "smallnorb", _label_of("label_azimuth"), "test[50%:]", 18),
    "smallnorb_label_elevation": VtabSpec(
        "smallnorb", _label_of("label_elevation"), "test[50%:]", 9),
    "kitti_closest_vehicle_distance": VtabSpec(
        "kitti", _kitti_closest_vehicle_distance, "test", 4),
}


def _decode_image(ex: Dict[str, list], image_key: str) -> np.ndarray:
    """The example's image as HWC uint8 RGB."""
    data = ex[image_key][0]
    if data[:6] == b"\x93NUMPY":
        return to_rgb_uint8(np.load(io.BytesIO(data)))
    with pil_image().open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


class TfdsClassificationDataset:
    """(image, label) dataset over a tfds-layout directory.

    Batched iteration as the other benchmark datasets: yields (images
    [B, H, W, 3] through `preprocess`, labels [B]).
    Records stream from disk per batch (nothing materialised: the
    diabetic_retinopathy test split alone is multiple GB); the split
    size comes from frame-header seeks at construction."""

    def __init__(self, name: str, root: str, preprocess,
                 split: str = "test", batch_size: int = 64):
        if name not in VTAB_TFDS:
            raise ValueError(f"{name}: not a tfds-layout vtab dataset; "
                             f"known: {sorted(VTAB_TFDS)}")
        self.spec = VTAB_TFDS[name]
        d = find_tfds_dir(root, self.spec.tfds_name)
        if d is None:
            raise FileNotFoundError(
                f"{name}: no tfds layout under {root!r} — expected "
                f"'{root}/{self.spec.tfds_name}/[<config>/]<version>/"
                f"{self.spec.tfds_name}-<split>.tfrecord-NNNNN-of-NNNNN' "
                "(a tensorflow_datasets data_dir; build it once with "
                "tfds elsewhere and copy it in: no tensorflow is needed "
                "to read it)")
        self.dir = d
        # 'test'/'train' map to the VTAB carves (task_adaptation
        # tfds_splits) so train never overlaps the carved test;
        # explicit slice specs pass through
        self.split_spec = {"test": self.spec.test_split,
                           "train": self.spec.train_split}.get(split, split)
        _, a, b, _ = _split_file_list(d, self.split_spec)
        self._num = max(0, b - a)
        self.preprocess = preprocess
        self.batch_size = batch_size
        self.classes = list(
            self.spec.classnames
            or [str(i) for i in range(self.spec.num_classes or 0)])

    def __len__(self):
        # sample count — the protocol of the sibling benchmark datasets
        # (builder.TorchClassificationDataset); batches via num_batches
        return self._num

    @property
    def num_batches(self):
        return (self._num + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self):
        return self._num

    def __iter__(self):
        def batches():
            imgs, labels = [], []
            for rec in iter_split_records(self.dir, self.split_spec):
                ex = parse_example(rec)
                img = _decode_image(ex, self.spec.image_key)
                if self.preprocess is not None:
                    img = self.preprocess(img)
                imgs.append(np.asarray(img))
                labels.append(self.spec.label_fn(ex))
                if len(imgs) == self.batch_size:
                    yield np.stack(imgs), np.asarray(labels, np.int64)
                    imgs, labels = [], []
            if imgs:
                yield np.stack(imgs), np.asarray(labels, np.int64)

        # overlap host decode with device compute like the torchvision/
        # coco readers already do
        return iter(Prefetcher(batches()))
