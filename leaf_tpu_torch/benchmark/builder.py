"""Benchmark dataset builder registry (port of
`leaf_tpu/benchmark/builder.py`).

Every dataset resolves to one of five local layouts:

  * **torchvision-native** (named datasets: cifar10/100, mnist, svhn,
    stl10, food101, dtd, pets, flowers, fgvc_aircraft, gtsrb, pcam,
    fer2013, eurosat, country211, renderedsst2, sun397, caltech101): the
    dataset's own file format read directly (`tv_datasets.py`), with no
    torchvision;
  * **imagefolder**: `root/<class_dir>/<image>` (class order = sorted
    directory names); WordNet-id directories map to the imagenet1k class
    names, the ImageNet-A/R/O 200-class subsets included, and numeric
    directories (imagenetv2) are remapped to the lexical folder order;
  * **wds**: `root/{split}/{split}-NNNN.tar` webdataset shards with `cls`
    (classification) members, plus an optional `root/classnames.txt`;
  * **retrieval csv/json**: a COCO Karpathy-style JSON or a flickr
    `captions.txt` (`mscoco_captions`, `flickr30k`, `flickr8k`);
  * **caption-selection json**: SugarCrepe-style records with `filename`,
    `caption` and `negative_caption`.

VOC 2007 (`voc2007.py`), ObjectNet and the tfds-layout VTAB datasets
(`tfds_datasets.py`) have readers of their own.  Class names and prompt
templates come from the port's own copies of the multilingual JSON tables
under `leaf_tpu_torch/benchmark/assets/` (en/cn/it/jp/ar and
babel-imagenet); templates use the `{c}` placeholder.

Images are HWC uint8 arrays until `preprocess`: `.npy` files and members
are read with numpy, encoded images with Pillow, imported where one is
opened (`models.preprocess.read_image`).
"""
from __future__ import annotations

import functools
import io
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from leaf_tpu_torch.data.common import Prefetcher
from leaf_tpu_torch.data.wds import IMAGE_EXTS, iter_tar_samples
from leaf_tpu_torch.models.preprocess import (pil_image, read_image,
                                              to_rgb_uint8)

LOG = logging.getLogger(__name__)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# datasets whose default task is retrieval / caption selection
RETRIEVAL_DATASETS = ("mscoco_captions", "flickr30k", "flickr8k",
                      "multilingual_mscoco_captions")
CAPTION_SELECTION_PREFIX = "sugar_crepe"

# the reference's named collections (`builder.py` dataset_collection)
DATASET_COLLECTIONS: Dict[str, List[str]] = {
    "vtab": ["caltech101", "cifar100", "dtd", "flowers", "pets",
             "svhn", "sun397", "eurosat", "resisc45", "pcam",
             "diabetic_retinopathy", "clevr_count_all",
             "clevr_closest_object_distance", "dsprites_label_orientation",
             "dsprites_label_x_position", "smallnorb_label_azimuth",
             "smallnorb_label_elevation", "dmlab", "kitti_closest_vehicle_distance"],
    "imagenet_robustness": ["imagenetv2", "imagenet_sketch", "imagenet-a",
                            "imagenet-r", "objectnet"],
    "retrieval": ["mscoco_captions", "flickr8k", "flickr30k"],
    "sugar_crepe": [f"sugar_crepe/{t}" for t in
                    ("add_att", "add_obj", "replace_att", "replace_obj",
                     "replace_rel", "swap_att", "swap_obj")],
}

# dataset name → classnames key in the language JSONs (most are 1:1)
_CLASSNAME_ALIASES = {
    "imagenet1k": "imagenet1k",
    "imagenetv2": "imagenet1k",
    "imagenet_sketch": "imagenet1k",
    "imagenet-a": "imagenet1k",
    "imagenet-r": "imagenet1k",
    "imagenet-o": "imagenet1k",
}


@functools.lru_cache()
def load_imagenet_wnids() -> Dict[str, List[str]]:
    """WordNet-id tables: `all` = the 1000 imagenet1k wnids in class
    order; `imagenet-a`/`-r`/`-o` = the 200-class subsets those
    benchmarks cover (public constants from the Hendrycks ImageNet-A/R/O
    releases; reference `datasets/builder.py:173,184,201,818`)."""
    with open(os.path.join(ASSETS, "imagenet_wnids.json")) as f:
        return json.load(f)


def imagenet_wnid_classnames(folder_classes: Sequence[str],
                             language: str = "en") -> Optional[List[str]]:
    """Classnames for a WordNet-id folder layout (imagenet1k val,
    imagenet_sketch, and the 200-class ImageNet-A/R/O subsets —
    reference `builder.py:162-203` builds the classifier over the
    masked classname list).  Returns None unless every class dir is a
    known imagenet1k wnid; labels follow the folder's sorted-dir order,
    so names are mapped per-dir (robust to partial subsets)."""
    wnids = load_imagenet_wnids()
    table = {}
    if os.path.exists(os.path.join(ASSETS, f"{language}_classnames.json")):
        table = load_language_classnames(language)
    full = table.get("imagenet1k") \
        or load_language_classnames("en")["imagenet1k"]
    wnid2name = dict(zip(wnids["all"], full))
    if not folder_classes \
            or not all(c in wnid2name for c in folder_classes):
        return None
    return [wnid2name[c] for c in folder_classes]


@functools.lru_cache()
def load_language_classnames(language: str = "en") -> Dict[str, List[str]]:
    path = os.path.join(ASSETS, f"{language}_classnames.json")
    with open(path) as f:
        return json.load(f)


@functools.lru_cache()
def load_language_templates(language: str = "en"
                            ) -> Optional[Dict[str, List[str]]]:
    path = os.path.join(
        ASSETS, f"{language}_zeroshot_classification_templates.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


@functools.lru_cache()
def load_nllb_prompts(language: str) -> Optional[List[str]]:
    """Machine-translated imagenet prompt set for babel-imagenet
    languages (reference `nllb_dist13b_prompts.json`)."""
    with open(os.path.join(ASSETS, "nllb_dist13b_prompts.json")) as f:
        table = json.load(f)
    return table.get(language.upper())


@functools.lru_cache()
def load_babel_imagenet(language: str) -> Optional[Tuple[List[int], List[str]]]:
    """Babel-ImageNet translated classnames: (class indices, names)."""
    with open(os.path.join(ASSETS, "babel_imagenet.json")) as f:
        table = json.load(f)
    v = table.get(language.upper())
    return (v[0], v[1]) if v else None


def get_dataset_default_task(name: str) -> str:
    if name.startswith(CAPTION_SELECTION_PREFIX):
        return "image_caption_selection"
    base = name[len("wds/"):] if name.startswith("wds/") else name
    if base in RETRIEVAL_DATASETS:
        return "zeroshot_retrieval"
    return "zeroshot_classification"


def classnames_and_templates(name: str, language: str = "en",
                             fallback_classes: Optional[Sequence[str]] = None
                             ) -> Tuple[List[str], List]:
    """(classnames, template callables) for a classification dataset.

    Templates are `'{c}'`-format strings turned into callables (the
    reference formats with `template.format(c=classname)`,
    `zeroshot_classification.py:52`)."""
    key = _CLASSNAME_ALIASES.get(name, name)
    table = load_language_classnames(language) \
        if os.path.exists(os.path.join(
            ASSETS, f"{language}_classnames.json")) else {}
    if key in table:
        classnames = table[key]
    elif key == "imagenet1k":
        babel = load_babel_imagenet(language)
        if babel is not None:
            classnames = babel[1]
        else:
            classnames = load_language_classnames("en")[key]
    elif fallback_classes is not None \
            and not _numeric_class_order(list(fallback_classes)):
        # dataset-shipped REAL classnames (classnames.txt / folder
        # names) define the label order — they win over the bundled
        # table, whose order may differ
        classnames = list(fallback_classes)
    elif key in load_language_classnames("en"):
        # the en table's real names beat NUMERIC folder placeholders —
        # evaluating flowers against the literal strings '0'..'101'
        # is near-random
        classnames = load_language_classnames("en")[key]
    elif fallback_classes is not None:
        classnames = list(fallback_classes)
    else:
        raise KeyError(
            f"no classnames for dataset {name!r} (language "
            f"{language!r}) and no folder classes to fall back on")

    tpl_table = load_language_templates(language)
    templates = None
    if tpl_table is not None:
        templates = tpl_table.get(key) or tpl_table.get("imagenet1k")
    if templates is None:
        templates = load_nllb_prompts(language)
    if templates is None:
        en = load_language_templates("en") or {}
        templates = en.get(key) or en.get("imagenet1k") \
            or ["a photo of a {c}."]
    # template strings use either the `{c}` or bare `{}` placeholder
    fns = [(lambda c, _t=t: _t.format(c=c) if "{c}" in _t
            else _t.format(c)) for t in templates]
    return list(classnames), fns


class BabelSubsetDataset:
    """Wrap a classification dataset, keeping only samples whose label
    has a translation and remapping labels to subset positions
    (reference `datasets/babel_imagenet.py` BabelImageNet)."""

    def __init__(self, base, class_indices: Sequence[int]):
        self.base = base
        self.classes = list(class_indices)
        self._remap = {int(c): i for i, c in enumerate(class_indices)}

    def __iter__(self):
        for images, labels in self.base:
            keep = np.asarray([int(l) in self._remap for l in labels])
            if not keep.any():
                continue
            labels = np.asarray([self._remap[int(l)]
                                 for l in np.asarray(labels)[keep]])
            yield np.asarray(images)[keep], labels


def _decode_member(data: bytes, ext: str) -> np.ndarray:
    """A tar member's image bytes -> HWC uint8 RGB."""
    if ext == "npy":
        return to_rgb_uint8(np.load(io.BytesIO(data)))
    with pil_image().open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


class WdsClassificationDataset:
    """Webdataset tar shards with integer `cls` members
    (the clip_benchmark wds layout: `root/{split}/{split}-%04d.tar` or
    a flat directory of tars; `root/classnames.txt` optional)."""

    def __init__(self, root: str, preprocess, split: str = "test",
                 batch_size: int = 64):
        import glob as _glob

        self.tars: List[str] = []
        split_dir = os.path.join(root, split)
        if os.path.isdir(split_dir):
            self.tars = sorted(_glob.glob(os.path.join(split_dir, "*.tar")))
        if not self.tars and os.path.isdir(root):
            # flat layout: {split}-NNNN.tar — filter by split so a root
            # holding several splits' shards never mixes them
            self.tars = sorted(
                _glob.glob(os.path.join(root, f"{split}*.tar")))
            if not self.tars:
                self.tars = sorted(_glob.glob(os.path.join(root, "*.tar")))
        if not self.tars:
            raise FileNotFoundError(f"no .tar shards under {root}")
        self.preprocess = preprocess
        self.batch_size = batch_size
        names = os.path.join(root, "classnames.txt")
        self.classes: List[str] = []
        if os.path.exists(names):
            self.classes = [l.strip() for l in open(names) if l.strip()]

    def __iter__(self):
        def batches():
            images, labels = [], []
            for tar in self.tars:
                for s in iter_tar_samples(tar):
                    if "cls" not in s:
                        continue
                    ext = next((e for e in IMAGE_EXTS if e in s), None)
                    if ext is None:
                        continue
                    img = _decode_member(s[ext], ext)
                    images.append(self.preprocess(img) if self.preprocess
                                  else img)
                    labels.append(int(s["cls"]))
                    if len(images) == self.batch_size:
                        yield np.stack(images), np.asarray(labels)
                        images, labels = [], []
            if images:
                yield np.stack(images), np.asarray(labels)

        return iter(Prefetcher(batches()))


class CaptionSelectionDataset:
    """SugarCrepe-style (image, [positive, negatives...]) pairs from a
    JSON annotation file (reference `datasets/sugar_crepe.py`)."""

    def __init__(self, image_root: str, annotation_file: str, preprocess,
                 batch_size: int = 64):
        with open(annotation_file) as f:
            data = json.load(f)
        records = list(data.values()) if isinstance(data, dict) else data
        self.items = [
            (r.get("filename") or r.get("image"),
             [r["caption"]] + ([r["negative_caption"]]
                               if "negative_caption" in r
                               else list(r.get("negative_captions", []))))
            for r in records
        ]
        self.image_root = image_root
        self.preprocess = preprocess
        self.batch_size = batch_size

    def __iter__(self):
        images, caption_lists = [], []
        for fname, captions in self.items:
            img = read_image(os.path.join(self.image_root, fname))
            images.append(self.preprocess(img) if self.preprocess else img)
            caption_lists.append(captions)
            if len(images) == self.batch_size:
                yield np.stack(images), caption_lists
                images, caption_lists = [], []
        if images:
            yield np.stack(images), caption_lists


class TorchClassificationDataset:
    """Batched iterator over a map-style classification dataset of (HWC
    uint8 array, label) items: (images through `preprocess`, labels),
    made on a background thread."""

    def __init__(self, ds, preprocess, batch_size: int = 64,
                 classes: Optional[List[str]] = None):
        self.ds = ds
        self.preprocess = preprocess
        self.batch_size = batch_size
        cls = classes if classes is not None else getattr(ds, "classes", [])
        self.classes = [str(c).replace("_", " ") for c in cls]

    def __len__(self):
        return len(self.ds)

    @property
    def num_batches(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def __iter__(self):
        def batches():
            n = len(self.ds)
            for b in range(self.num_batches):
                idx = range(b * self.batch_size,
                            min((b + 1) * self.batch_size, n))
                imgs, labels = [], []
                for i in idx:
                    img, label = self.ds[i]
                    imgs.append(self.preprocess(img))
                    # int for single-label, a 0/1 vector for multilabel
                    labels.append(label)
                yield np.stack(imgs), np.asarray(labels)

        return iter(Prefetcher(batches()))


def build_objectnet(root: str):
    """ObjectNet restricted to its ImageNet-overlapping classes
    (reference `datasets/objectnet.py`, adapted from wise-ft): the
    mapping JSONs ship WITH the dataset (`root/mappings/` or `root/`);
    classnames are the lowercased ObjectNet label names, samples are
    the image-folder dirs that map to an ImageNet class."""
    from leaf_tpu_torch.benchmark.tv_datasets import NativeDataset, crop
    from leaf_tpu_torch.data.imagenet import list_image_folder

    def load_mapping(fn):
        for d in (root, os.path.join(root, "mappings"),
                  os.path.join(root, "objectnet-1.0", "mappings")):
            path = os.path.join(d, fn)
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
        raise FileNotFoundError(
            f"objectnet: mapping file {fn!r} not found under {root!r} "
            "(ships with the dataset)")

    folder_to_label = load_mapping("folder_to_objectnet_label.json")
    overlap = load_mapping("objectnet_to_imagenet_1k.json")
    label_to_folder = {v: k for k, v in folder_to_label.items()}
    folders = sorted(label_to_folder[name] for name in overlap)
    classes = [folder_to_label[f].lower() for f in folders]
    label_map = {f: i for i, f in enumerate(folders)}

    img_root = os.path.join(root, "objectnet-1.0", "images")
    if not os.path.isdir(img_root):
        img_root = os.path.join(root, "images") \
            if os.path.isdir(os.path.join(root, "images")) else root
    paths, labels, dir_classes = list_image_folder(img_root)
    samples = [(p, label_map[dir_classes[l]])
               for p, l in zip(paths, labels)
               if dir_classes[l] in label_map]

    def loader(path):
        # every ObjectNet image has a ~2px red frame; the reference
        # (wise-ft adaptation) crops it before preprocessing
        img = read_image(path)
        h, w = img.shape[:2]
        return crop(img, (2, 2, w - 2, h - 2))

    return NativeDataset(samples, classes, loader=loader)


def _numeric_class_order(classes: List[str]) -> bool:
    return bool(classes) and all(c.isdigit() for c in classes)


def build_dataset(name: str, root: str, preprocess, split: str = "test",
                  batch_size: int = 64, language: str = "en",
                  annotation_file: str = ""):
    """name → (dataset, task, classnames, templates).

    classnames/templates are None for non-classification tasks."""
    task = get_dataset_default_task(name)
    root = root.format(dataset=name.replace("/", "-"), language=language)

    if task == "image_caption_selection":
        ann = annotation_file
        if not ann:
            sub = name.split("/", 1)[1] if "/" in name else "all"
            ann = os.path.join(root, f"{sub}.json")
        ds = CaptionSelectionDataset(
            os.path.join(root, "images") if os.path.isdir(
                os.path.join(root, "images")) else root,
            ann, preprocess, batch_size)
        return ds, task, None, None

    if task == "zeroshot_retrieval":
        from leaf_tpu_torch.data.coco import CocoRetrievalDataset
        if not annotation_file:
            raise ValueError(
                f"{name}: retrieval needs --annotation-file (Karpathy-"
                "style JSON: [{'image': ..., 'caption': [...]}, ...])")
        ds = CocoRetrievalDataset(root, annotation_file, preprocess,
                                  batch_size=batch_size)
        return ds, task, None, None

    # classification
    if name.startswith("wds/"):
        ds = WdsClassificationDataset(root, preprocess, split, batch_size)
        base = name[len("wds/"):]
        if base.startswith("vtab/"):
            # classname/template tables key on the bare dataset name
            base = base[len("vtab/"):]
        classnames, templates = classnames_and_templates(
            base, language, fallback_classes=ds.classes or None)
        if _CLASSNAME_ALIASES.get(base) == "imagenet1k" \
                and language not in ("en", "cn", "it", "jp", "ar"):
            babel = load_babel_imagenet(language)
            if babel is not None:
                # babel translates a class SUBSET: remap labels like the
                # imagefolder branch does
                ds = BabelSubsetDataset(ds, babel[0])
        return ds, task, classnames, templates

    from leaf_tpu_torch.benchmark.tfds_datasets import VTAB_TFDS, find_tfds_dir
    from leaf_tpu_torch.benchmark.tv_datasets import (NATIVE_DATASETS,
                                                load_native_dataset)
    if name in NATIVE_DATASETS:
        try:
            nat = load_native_dataset(name, root, split)
        except FileNotFoundError:
            # a name in both registries (pcam) may sit in the tfds
            # layout instead of the torchvision one
            if name in VTAB_TFDS \
                    and find_tfds_dir(root, VTAB_TFDS[name].tfds_name):
                nat = None
            else:
                raise
        if nat is not None:
            ds = TorchClassificationDataset(nat, preprocess, batch_size)
            classnames, templates = classnames_and_templates(
                name, language, fallback_classes=ds.classes or None)
            return ds, task, classnames, templates

    if name in ("voc2007", "voc2007_multilabel"):
        from leaf_tpu_torch.benchmark.voc2007 import (Voc2007Cropped,
                                                Voc2007Multilabel)
        cls = Voc2007Multilabel if name.endswith("multilabel") \
            else Voc2007Cropped
        nat = cls(root, "train" if split == "train" else "test")
        ds = TorchClassificationDataset(nat, preprocess, batch_size)
        classnames, templates = classnames_and_templates(
            "voc2007", language, fallback_classes=ds.classes)
        return ds, task, classnames, templates

    if name in VTAB_TFDS:
        # tfds-layout vtab datasets (resisc45/clevr/dsprites/smallnorb/
        # dmlab/kitti/diabetic_retinopathy/pcam) — native TFRecord
        # reader, no tensorflow (reference builds these via
        # tensorflow_datasets + task_adaptation,
        # `datasets/builder.py:476-600`).  A missing/mismatched layout
        # raises a loud error naming the expected tfds directory
        # structure instead of silently falling through.
        from leaf_tpu_torch.benchmark.tfds_datasets import (
            TfdsClassificationDataset,
        )
        ds = TfdsClassificationDataset(name, root, preprocess, split,
                                       batch_size)
        classnames, templates = classnames_and_templates(
            name, language, fallback_classes=ds.classes)
        return ds, task, classnames, templates

    if name == "objectnet":
        nat = build_objectnet(root)
        ds = TorchClassificationDataset(nat, preprocess, batch_size,
                                        classes=nat.classes)
        templates = classnames_and_templates(
            "imagenet1k", language)[1]
        return ds, task, ds.classes, templates

    from leaf_tpu_torch.data.imagenet import ImageFolderDataset
    sub = os.path.join(root, split)
    ds = ImageFolderDataset(sub if os.path.isdir(sub) else root, preprocess,
                            batch_size=batch_size)
    if _numeric_class_order(ds.classes) \
            and _CLASSNAME_ALIASES.get(name) == "imagenet1k":
        # imagenetv2-style layout: class dirs "0".."999"; sorted-dir
        # label order is lexical, the classname table's is numeric
        # (reference `datasets/imagenetv2.py`) — remap the classnames
        # to the folder's label order
        babel = (load_babel_imagenet(language)
                 if language not in ("en", "cn", "it", "jp", "ar")
                 else None)
        if babel is not None:
            # babel translates a class SUBSET: keep only its classes
            # (babel[1] is indexed by subset position, NOT class id)
            keep_ids, babel_names = babel
            id_order = [int(c) for c in ds.classes]  # label → class id
            keep_set = set(keep_ids)
            label_keep = [i for i, cid in enumerate(id_order)
                          if cid in keep_set]
            ds = BabelSubsetDataset(ds, label_keep)
            pos = {cid: j for j, cid in enumerate(keep_ids)}
            classnames = [babel_names[pos[id_order[i]]]
                          for i in label_keep]
            _, templates = classnames_and_templates("imagenet1k", language)
            return ds, task, classnames, templates
        base_names, templates = classnames_and_templates(name, language)
        classnames = [base_names[int(c)] for c in ds.classes]
        return ds, task, classnames, templates
    wnid_names = imagenet_wnid_classnames(ds.classes, language)
    if wnid_names is not None and len(wnid_names) < 1000:
        # wnid-dir layout covering a proper subset: the ImageNet-A/R/O
        # 200-class benchmarks.  (A full 1000-dir layout falls through
        # to the table path, which also handles babel languages.)
        _, templates = classnames_and_templates("imagenet1k", language)
        return ds, task, wnid_names, templates
    classnames, templates = classnames_and_templates(
        name, language, fallback_classes=ds.classes)
    key = _CLASSNAME_ALIASES.get(name, name)
    if key == "imagenet1k" and language != "en" \
            and language not in ("cn", "it", "jp", "ar"):
        babel = load_babel_imagenet(language)
        if babel is not None:
            # babel-imagenet translates a class SUBSET: evaluate on
            # those classes only, labels remapped (reference
            # babel_imagenet.py)
            ds = BabelSubsetDataset(ds, babel[0])
    return ds, task, classnames, templates
