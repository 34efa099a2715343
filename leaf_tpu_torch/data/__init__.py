"""Data layer of the port: host-side pipelines feeding numpy batches to
the device (port of `leaf_tpu/data/__init__.py`).

`get_data` assembles the trainers' datasets: train (webdataset tars,
CSV or synthetic), val (tars, in order), the ImageNet folders, and the
text-classification eval sets.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from leaf_tpu_torch.data.csv_data import get_csv_dataset
from leaf_tpu_torch.data.imagenet import get_imagenet
from leaf_tpu_torch.data.synthetic import get_synthetic_dataset
from leaf_tpu_torch.data.textcls import (TextClassificationData,
                                         get_text_classification_dataset)
from leaf_tpu_torch.data.wds import WdsConfig, get_wds_dataset


def _length_fn(model: str):
    """Caption -> its token count with SOT and EOT, capped at the
    context length (`--bucket-by-length`)."""
    from leaf_tpu_torch.models.factory import get_tokenizer
    tok = get_tokenizer(model)
    ctx = tok.context_length

    def length_fn(text: str) -> int:
        return min(len(tok.encode(text)) + 2, ctx)

    return length_fn


def get_data(args, preprocess: Callable, epoch: int = 0,
             process_index: int = 0, process_count: int = 1,
             text_only: bool = False,
             preprocess_val: Optional[Callable] = None) -> Dict[str, object]:
    """Assemble datasets from a parsed-args namespace (see
    `leaf_tpu_torch.train.params`).  `text_only` skips image decode in
    the train pipelines (the LEAF text-AT loop discards images).
    `preprocess_val` (default: `preprocess`) serves the val and ImageNet
    splits.
    `epoch` is the JAX package's argument and changes nothing."""
    del epoch
    data: Dict[str, object] = {}
    preprocess_val = preprocess_val or preprocess
    bucket = getattr(args, "bucket_by_length", False)
    length_fn = _length_fn(getattr(args, "model", "") or "") if bucket else None

    if getattr(args, "dataset_type", None) == "synthetic":
        data["train"] = get_synthetic_dataset(
            args.train_num_samples or 100, args.batch_size,
            image_size=getattr(args, "image_size", 224), seed=args.seed,
            preprocess=preprocess)
    elif getattr(args, "train_data", None):
        if args.dataset_type in ("webdataset", "auto"):
            factors = getattr(args, "train_data_upsampling_factors", None)
            data["train"] = get_wds_dataset(
                WdsConfig(urls=args.train_data, batch_size=args.batch_size,
                          is_train=True, seed=args.seed,
                          num_samples=args.train_num_samples,
                          resampled=getattr(args, "dataset_resampled", False),
                          process_index=process_index,
                          process_count=process_count,
                          text_only=text_only,
                          workers=getattr(args, "workers", 4),
                          bucket_by_length=bucket, length_fn=length_fn,
                          upsampling_factors=(
                              [float(x) for x in factors.split("::")]
                              if factors else None)),
                preprocess)
        elif args.dataset_type == "csv":
            data["train"] = get_csv_dataset(
                args.train_data, preprocess, args.batch_size,
                img_key=args.csv_img_key, caption_key=args.csv_caption_key,
                sep=args.csv_separator, shuffle=True, seed=args.seed,
                drop_last=True, process_index=process_index,
                process_count=process_count, text_only=text_only)

    if getattr(args, "val_data", None):
        data["val"] = get_wds_dataset(
            WdsConfig(urls=args.val_data, batch_size=args.batch_size,
                      is_train=False, num_samples=args.val_num_samples),
            preprocess_val)

    for key, flag in (("imagenet-val", "imagenet_val"),
                      ("imagenet-v2", "imagenet_v2")):
        if getattr(args, flag, None):
            data[key] = get_imagenet(
                getattr(args, flag), preprocess_val, "val", args.batch_size,
                n_val=getattr(args, "n_val_imagenet", 1000), seed=args.seed)

    if getattr(args, "val_text_classification", None):
        n = getattr(args, "n_val_text", 200)
        if args.val_text_classification == "synthetic":
            # the in-training eval's code path without the hub: synthetic
            # sentences with round-robin labels over each dataset's real
            # class and anchor metadata
            from leaf_tpu_torch.evals.textfare import _load_eval_samples
            samples, _ = _load_eval_samples("synthetic", n)
            for name, n_classes in (("agnews", 4), ("sst2", 2)):
                labeled = [dict(s, label=i % n_classes)
                           for i, s in enumerate(samples)]
                data[f"train-{name}"] = TextClassificationData.from_samples(
                    name, labeled)
        else:
            for name in ("agnews", "sst2"):
                data[f"train-{name}"] = get_text_classification_dataset(
                    name, n_samples=n, test=False)

    return data
