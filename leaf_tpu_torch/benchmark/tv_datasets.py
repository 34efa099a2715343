"""Native readers for the on-disk layouts of torchvision's datasets (port
of `leaf_tpu/benchmark/tv_datasets.py`).

Each dataset's own file layout is read directly (CIFAR pickle batches,
MNIST idx files, SVHN and Flowers `.mat` files through scipy, STL10
binaries, metadata text files, PCam HDF5 through h5py, FER2013 CSV), with
no torchvision and no download: the data must already sit under the root
in the layout torchvision would have produced.  Every loader returns a
`NativeDataset`, a map-style dataset of (HWC uint8 RGB array, label) with
a `.classes` list.  Where the JAX package hands Pillow images on, the port
hands arrays: files are read by `models.preprocess.read_image` (`.npy`
with numpy, encoded images with Pillow, imported where one is opened).
scipy and h5py are imported inside the readers that need them.
"""
from __future__ import annotations

import gzip
import json
import os
import pickle
import struct
from typing import Callable, List, Optional, Sequence

import numpy as np

from leaf_tpu_torch.models.preprocess import read_image, to_rgb_uint8

__all__ = ["NATIVE_DATASETS", "NativeDataset", "load_native_dataset"]


def crop(arr: np.ndarray, box) -> np.ndarray:
    """Pillow's `Image.crop((left, top, right, bottom))` on an HWC array:
    pixels outside the image are zero."""
    left, top, right, bottom = (int(v) for v in box)
    out = np.zeros((max(bottom - top, 0), max(right - left, 0))
                   + arr.shape[2:], arr.dtype)
    h, w = arr.shape[:2]
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = arr[y0:y1, x0:x1]
    return out


class NativeDataset:
    """Map-style (image, label) dataset over in-memory arrays or paths:
    item i is (HWC uint8 RGB array, int label)."""

    def __init__(self, samples: Sequence, classes: List[str],
                 loader: Optional[Callable] = None):
        self.samples = list(samples)      # (array-or-path, label)
        self.classes = classes
        self._loader = loader

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        item, label = self.samples[i]
        if self._loader is not None:
            img = self._loader(item)
        elif isinstance(item, np.ndarray):
            img = item
        else:
            img = read_image(item)
        return to_rgb_uint8(img), int(label)


def _missing(name: str, path: str):
    raise FileNotFoundError(f"{name}: expected {path}")


# ---------------------------------------------------------------------------
# binary formats
# ---------------------------------------------------------------------------

def _cifar(root: str, split: str, n_classes: int) -> NativeDataset:
    """CIFAR pickle batches (`cifar-10-batches-py` / `cifar-100-python`)."""
    if n_classes == 10:
        d = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] \
            if split == "train" else ["test_batch"]
        label_key, names_key = b"labels", b"label_names"
    else:
        d = os.path.join(root, "cifar-100-python")
        files = ["train"] if split == "train" else ["test"]
        label_key, names_key = b"fine_labels", b"fine_label_names"
    if not os.path.isdir(d):
        _missing(f"cifar{n_classes}", d)
    imgs, labels = [], []
    for fn in files:
        with open(os.path.join(d, fn), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        data = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        imgs.append(np.ascontiguousarray(data))
        labels.extend(batch[label_key])
    with open(os.path.join(d, "batches.meta" if n_classes == 10
                           else "meta"), "rb") as f:
        meta = pickle.load(f, encoding="bytes")
    classes = [n.decode() for n in meta[names_key]]
    imgs = np.concatenate(imgs)
    return NativeDataset(list(zip(imgs, labels)), classes)


def _read_idx(path: str) -> np.ndarray:
    """MNIST idx file (optionally .gz)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _mnist(root: str, split: str) -> NativeDataset:
    d = os.path.join(root, "MNIST", "raw")
    if not os.path.isdir(d):
        d = root
    prefix = "train" if split == "train" else "t10k"
    img_path = lbl_path = None
    for suff in ("", ".gz"):
        p = os.path.join(d, f"{prefix}-images-idx3-ubyte{suff}")
        q = os.path.join(d, f"{prefix}-labels-idx1-ubyte{suff}")
        if os.path.exists(p) and os.path.exists(q):
            img_path, lbl_path = p, q
            break
    if img_path is None:
        _missing("mnist", os.path.join(d, f"{prefix}-images-idx3-ubyte"))
    imgs = _read_idx(img_path)
    labels = _read_idx(lbl_path)
    return NativeDataset(list(zip(imgs, labels.tolist())),
                         [f"{i}" for i in range(10)])


def _svhn(root: str, split: str) -> NativeDataset:
    from scipy.io import loadmat

    path = os.path.join(root, f"{split}_32x32.mat")
    if not os.path.exists(path):
        _missing("svhn", path)
    mat = loadmat(path)
    imgs = np.transpose(mat["X"], (3, 0, 1, 2))   # HWCN -> NHWC
    labels = mat["y"].ravel().astype(int) % 10    # label "10" is digit 0
    return NativeDataset(list(zip(imgs, labels.tolist())),
                         [f"{i}" for i in range(10)])


def _stl10(root: str, split: str) -> NativeDataset:
    d = os.path.join(root, "stl10_binary")
    if not os.path.isdir(d):
        _missing("stl10", d)
    with open(os.path.join(d, f"{split}_X.bin"), "rb") as f:
        imgs = np.frombuffer(f.read(), np.uint8)
    imgs = imgs.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
    with open(os.path.join(d, f"{split}_y.bin"), "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8).astype(int) - 1
    with open(os.path.join(d, "class_names.txt")) as f:
        classes = [l.strip() for l in f if l.strip()]
    return NativeDataset(list(zip(imgs, labels.tolist())), classes)


# ---------------------------------------------------------------------------
# metadata-file formats
# ---------------------------------------------------------------------------

def _food101(root: str, split: str) -> NativeDataset:
    d = os.path.join(root, "food-101")
    if not os.path.isdir(d):
        d = root
    meta = os.path.join(d, "meta", f"{split}.json")
    if not os.path.exists(meta):
        _missing("food101", meta)
    with open(meta) as f:
        table = json.load(f)                       # class -> ["class/img"]
    classes = sorted(table)
    samples = [(os.path.join(d, "images", rel + ".jpg"), ci)
               for ci, c in enumerate(classes) for rel in table[c]]
    return NativeDataset(samples, [c.replace("_", " ") for c in classes])


def _dtd(root: str, split: str, partition: int = 1) -> NativeDataset:
    d = os.path.join(root, "dtd")
    if not os.path.isdir(d):
        d = root
    lst = os.path.join(d, "labels", f"{split}{partition}.txt")
    if not os.path.exists(lst):
        _missing("dtd", lst)
    with open(lst) as f:
        rels = [l.strip() for l in f if l.strip()]
    classes = sorted({r.split("/")[0] for r in rels})
    idx = {c: i for i, c in enumerate(classes)}
    samples = [(os.path.join(d, "images", r), idx[r.split("/")[0]])
               for r in rels]
    return NativeDataset(samples, classes)


def _pets(root: str, split: str) -> NativeDataset:
    ann = os.path.join(root, "annotations",
                       "trainval.txt" if split == "train" else "test.txt")
    if not os.path.exists(ann):
        _missing("pets", ann)
    samples, names = [], {}
    with open(ann) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            stem, class_id = line.split()[:2]
            label = int(class_id) - 1
            names[label] = " ".join(stem.split("_")[:-1]).lower()
            samples.append((os.path.join(root, "images", stem + ".jpg"),
                            label))
    return NativeDataset(samples, [names[i] for i in range(len(names))])


def _flowers102(root: str, split: str) -> NativeDataset:
    from scipy.io import loadmat

    d = os.path.join(root, "flowers-102")
    if not os.path.isdir(d):
        d = root
    lbl = os.path.join(d, "imagelabels.mat")
    if not os.path.exists(lbl):
        _missing("flowers", lbl)
    labels = loadmat(lbl)["labels"].ravel().astype(int) - 1
    setid = loadmat(os.path.join(d, "setid.mat"))
    key = {"train": "trnid", "val": "valid", "test": "tstid"}[split]
    keep = setid[key].ravel().astype(int)
    samples = [(os.path.join(d, "jpg", f"image_{i:05d}.jpg"),
                int(labels[i - 1])) for i in keep]
    # the names come from the language tables
    return NativeDataset(samples, [f"{i}" for i in range(102)])


def _fgvc_aircraft(root: str, split: str) -> NativeDataset:
    d = os.path.join(root, "fgvc-aircraft-2013b", "data")
    if not os.path.isdir(d):
        d = root
    lst = os.path.join(d, f"images_variant_{split}.txt")
    if not os.path.exists(lst):
        _missing("fgvc_aircraft", lst)
    with open(os.path.join(d, "variants.txt")) as f:
        classes = [l.strip() for l in f if l.strip()]
    idx = {c: i for i, c in enumerate(classes)}
    samples = []
    with open(lst) as f:
        for line in f:
            img, variant = line.strip().split(" ", 1)
            samples.append((os.path.join(d, "images", img + ".jpg"),
                            idx[variant]))
    return NativeDataset(samples, classes)


def _gtsrb(root: str, split: str) -> NativeDataset:
    d = os.path.join(root, "gtsrb")
    if not os.path.isdir(d):
        d = root
    samples = []
    if split == "train":
        base = os.path.join(d, "GTSRB", "Training")
        if not os.path.isdir(base):
            _missing("gtsrb", base)
        for cdir in sorted(os.listdir(base)):
            full = os.path.join(base, cdir)
            if not os.path.isdir(full):
                continue
            samples.extend((os.path.join(full, fn), int(cdir))
                           for fn in sorted(os.listdir(full))
                           if fn.lower().endswith(".ppm"))
    else:
        csv_path = os.path.join(d, "GT-final_test.csv")
        img_dir = os.path.join(d, "GTSRB", "Final_Test", "Images")
        if not os.path.exists(csv_path):
            _missing("gtsrb", csv_path)
        with open(csv_path) as f:
            header = f.readline().strip().split(";")
            fi, ci = header.index("Filename"), header.index("ClassId")
            for line in f:
                parts = line.strip().split(";")
                samples.append((os.path.join(img_dir, parts[fi]),
                                int(parts[ci])))
    return NativeDataset(samples, [f"{i}" for i in range(43)])


def _pcam(root: str, split: str) -> NativeDataset:
    """PatchCamelyon HDF5 pairs (`camelyonpatch_level_2_split_<s>_{x,y}.h5`),
    images read lazily per index (the train split's X is ~7 GB)."""
    import h5py

    d = os.path.join(root, "pcam")
    if not os.path.isdir(d):
        d = root
    s = {"val": "valid"}.get(split, split)
    xs = os.path.join(d, f"camelyonpatch_level_2_split_{s}_x.h5")
    ys = os.path.join(d, f"camelyonpatch_level_2_split_{s}_y.h5")
    if not os.path.exists(xs):
        _missing("pcam", xs)
    with h5py.File(ys) as f:
        labels = np.asarray(f["y"]).ravel().astype(int)
    x = h5py.File(xs)["x"]          # kept open; closed with the process
    classes = ["lymph node", "lymph node containing metastatic tumor tissue"]
    return NativeDataset(list(zip(range(len(labels)), labels.tolist())),
                         classes, loader=lambda i: np.asarray(x[int(i)]))


def _fer2013(root: str, split: str) -> NativeDataset:
    """FER-2013 CSV (48 x 48 gray pixels as a space-separated string)."""
    import csv

    d = os.path.join(root, "fer2013")
    if not os.path.isdir(d):
        d = root
    path = os.path.join(d, f"{'train' if split == 'train' else 'test'}.csv")
    if not os.path.exists(path):
        _missing("fer2013", path)
    samples = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None or "emotion" not in reader.fieldnames:
            raise ValueError(
                "fer2013: csv has no 'emotion' column: the Kaggle unlabeled "
                "test split cannot be evaluated; use the labeled csv (icml "
                "face data) instead")
        for row in reader:
            img = np.asarray(row["pixels"].split(), np.uint8)
            img = np.repeat(img.reshape(48, 48, 1), 3, axis=-1)
            samples.append((img, int(row["emotion"])))
    classes = ["angry", "disgust", "fear", "happy", "sad", "surprise",
               "neutral"]
    return NativeDataset(samples, classes)


def _sun397(root: str) -> NativeDataset:
    """SUN397: images at SUN397/<letter>/<class...>/sun_*.jpg, the classes
    listed in ClassName.txt (possibly nested, e.g. /t/tent/outdoor)."""
    d = os.path.join(root, "SUN397")
    if not os.path.isdir(d):
        d = root
    listing = os.path.join(d, "ClassName.txt")
    if not os.path.exists(listing):
        _missing("sun397", listing)
    with open(listing) as f:
        rels = [l.strip() for l in f if l.strip()]
    classes = [" ".join(r.lstrip("/").split("/")[1:]).replace("_", " ")
               for r in rels]
    samples = []
    for ci, rel in enumerate(rels):
        cdir = os.path.join(d, rel.lstrip("/"))
        if not os.path.isdir(cdir):
            continue
        samples.extend(
            (os.path.join(cdir, fn), ci) for fn in sorted(os.listdir(cdir))
            if fn.lower().endswith((".jpg", ".jpeg", ".png", ".npy")))
    return NativeDataset(samples, classes)


def _imagefolder_like(name: str, subdir: str = ""):
    """Datasets whose native layout is (a subdirectory of) an image folder
    (EuroSAT, Country211, RenderedSST2, Caltech101)."""

    def make(root: str, split: str) -> NativeDataset:
        from leaf_tpu_torch.data.imagenet import list_image_folder

        d = os.path.join(root, subdir) if subdir else root
        sub = os.path.join(d, split)
        if os.path.isdir(sub):
            d = sub
        if not os.path.isdir(d):
            _missing(name, d)
        paths, labels, classes = list_image_folder(d)
        classes = [c.replace("_", " ") for c in classes]
        return NativeDataset(list(zip(paths, labels)), classes)

    return make


# name -> loader(root, split); the split follows torchvision's convention
NATIVE_DATASETS = {
    "cifar10": lambda r, s: _cifar(r, s, 10),
    "cifar100": lambda r, s: _cifar(r, s, 100),
    "mnist": _mnist,
    "svhn": _svhn,
    "stl10": _stl10,
    "food101": _food101,
    "dtd": _dtd,
    "pets": _pets,
    "flowers": _flowers102,
    "fgvc_aircraft": _fgvc_aircraft,
    "gtsrb": _gtsrb,
    "pcam": _pcam,
    "fer2013": _fer2013,
    "eurosat": _imagefolder_like("eurosat", "2750"),
    "country211": _imagefolder_like("country211", "country211"),
    "renderedsst2": _imagefolder_like("renderedsst2", "rendered-sst2"),
    "sun397": lambda r, s: _sun397(r),
    "caltech101": _imagefolder_like(
        "caltech101", os.path.join("caltech101", "101_ObjectCategories")),
}


def load_native_dataset(name: str, root: str, split: str) -> NativeDataset:
    try:
        return NATIVE_DATASETS[name](root, split)
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{name}: expected the dataset in its torchvision-native layout "
            f"under {root!r} (there is no download): {e}") from e
