"""Benchmark command line (port of `leaf_tpu/benchmark/cli.py`):

  python -m leaf_tpu_torch.benchmark.cli eval \\
      --model ViT-L-14 --pretrained ckpt.safetensors \\
      --dataset imagenet1k --dataset-root /data/imagenet \\
      [--task auto] [--language en] [--attack apgd] \\
      [--interpolate --beta 0.5 --interpolate-ckpt clean.safetensors] \\
      --output '{dataset}_{model}_{task}.json' [--device cuda]

  python -m leaf_tpu_torch.benchmark.cli build r1.json r2.json \\
      --output benchmark.csv
  python -m leaf_tpu_torch.benchmark.cli reformat benchmark.csv \\
      --output pivoted.csv

Tasks: zeroshot_classification (clean, or `--attack apgd` for the
AutoAttack-style robust top-1), zeroshot_retrieval, linear_probe,
image_caption_selection, captioning (a CoCa model's captions of a
retrieval dataset's images, by group beam search, with BLEU-4 and CIDEr-D
against its captions); `--task auto` infers the task from the dataset
name.  Datasets resolve through `builder.build_dataset`; `--dataset` also
takes a collection name (vtab, retrieval, imagenet_robustness,
sugar_crepe) or a text file of names.  The JSON result files and the CSV
tables are the JAX command line's.

Beyond the JAX command line: `--device` (default `cuda`),
`--generation-type top_k` captions with the greedy loop in place of the
beam search, and `--precision bf16` computes the towers in bf16.  The JAX
command line passes `--precision` to `create_model`, which sets the
model's compute dtype, but its benchmark functions take the fp32
parameters and never read that dtype, so it computes in fp32 whatever the
flag (the port's default); the logits are fp32 with TF32 off either way.
`reformat` keeps the rows with an empty index cell (a clean result has no
`eps`), which the JAX command line's pandas pivot drops; it needs no
pandas.  `--model-type hf_clip` (the model an HF repo id) and registry or
`hf-hub:` `--pretrained` tags load from the local checkpoint cache
(`models/pretrained.py`); nothing is fetched.  Models whose tokenizer is
an HF one (`coca_roberta-*`, the HF-text and SigLIP/CLIPA towers) raise at
`get_tokenizer`: `transformers` and their vocabulary files are absent.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import math
import os
import time
from typing import Dict, List, Optional

from leaf_tpu_torch.utils.logging_utils import setup_logging

LOG = logging.getLogger(__name__)


def _interpolate(module, other: Dict, beta: float) -> None:
    """theta <- beta * theta + (1 - beta) * theta_other, in place, in fp32
    (beta 0 gives the other model)."""
    import torch
    with torch.no_grad():
        for name, p in module.state_dict().items():
            p.copy_(beta * p + (1 - beta) * other[name].to(p.device, p.dtype))


def _expand_datasets(specs: List[str]) -> List[str]:
    from leaf_tpu_torch.benchmark.builder import DATASET_COLLECTIONS
    out: List[str] = []
    for s in specs:
        if s in DATASET_COLLECTIONS:
            out.extend(DATASET_COLLECTIONS[s])
        elif os.path.isfile(s) and s.endswith(".txt"):
            out.extend(l.strip() for l in open(s) if l.strip())
        else:
            out.append(s)
    return out


def _load_model(args, model_name: str, pretrained: str):
    """(CLIP module, cfg, tokenizer, preprocess), made once per model and
    shared across every dataset of an eval run.  The module's weights take
    no gradient (the attack needs the images' gradient alone)."""
    import torch

    from leaf_tpu_torch.models import interop
    from leaf_tpu_torch.models.factory import (PRECISIONS, _cast_weights,
                                               create_model, get_tokenizer,
                                               local_checkpoint)
    from leaf_tpu_torch.models.preprocess import image_transform

    model_type = getattr(args, "model_type", "open_clip")
    if model_type == "ja_clip":
        try:
            import japanese_clip  # noqa: F401
        except ImportError:
            raise ImportError(
                "Install `japanese_clip` by `pip install "
                "git+https://github.com/rinnakk/japanese-clip.git`")
        raise NotImplementedError(
            "ja_clip models use rinna's own loader, which has no port: use "
            "--model-type open_clip")
    if model_type == "hf_clip":
        if pretrained not in ("", "none", None):
            raise ValueError(
                "--model-type hf_clip takes the HF repo id as --model; "
                "--pretrained must be empty")
        # the repo id names the model: its config and weights come from
        # the local snapshot (`pretrained.download_pretrained_from_hf`)
        if not model_name.startswith("hf-hub:"):
            model_name = "hf-hub:" + model_name
    if args.precision not in PRECISIONS:
        raise ValueError(f"--precision {args.precision!r}: one of "
                         f"{sorted(PRECISIONS)}")
    model = create_model(model_name,
                         local_checkpoint(pretrained or None, "--pretrained",
                                          model_name),
                         precision="fp32", seed=args.seed,
                         device=args.device, master_weights=True)
    module, cfg = model.module, model.cfg
    module.requires_grad_(False)
    if args.interpolate:
        if not args.interpolate_ckpt:
            raise ValueError("--interpolate needs --interpolate-ckpt")
        other = interop.load_pretrained(
            local_checkpoint(args.interpolate_ckpt, "--interpolate-ckpt"),
            cfg)
        _interpolate(module, other, args.beta)
    if PRECISIONS[args.precision] != torch.float32:
        module.text.compute_dtype = None
        _cast_weights(module, PRECISIONS[args.precision])
    preprocess = image_transform(cfg.vision.image_size, do_normalize=False)
    return module, cfg, get_tokenizer(model_name), preprocess


def run_one(args, dataset_name: str, model_name: str, pretrained: str,
            loaded=None, seconds: Optional[Dict[str, float]] = None) -> dict:
    """One (model, dataset) evaluation: its result dict, written and
    printed as the JAX command line does.  `seconds`, if given, gains the
    task's part seconds (see each `evaluate_*`)."""
    from leaf_tpu_torch.benchmark.builder import build_dataset

    if args.task == "captioning":
        return _run_captioning(args, dataset_name, model_name, pretrained,
                               seconds)
    module, cfg, tokenizer, preprocess = \
        loaded if loaded is not None \
        else _load_model(args, model_name, pretrained)

    task = args.task
    ds, default_task, classnames, templates = build_dataset(
        dataset_name, args.dataset_root, preprocess, split=args.split,
        batch_size=args.batch_size, language=args.language,
        annotation_file=args.annotation_file)
    if task == "auto":
        task = default_task

    if task == "zeroshot_classification":
        from leaf_tpu_torch.benchmark.zeroshot_classification import (
            evaluate_zeroshot_classification)
        metrics = evaluate_zeroshot_classification(
            module, cfg, tokenizer, ds, classnames, templates,
            attack=args.attack, eps=args.eps / 255.0,
            n_iter=args.attack_iters, seconds=seconds)
    elif task == "zeroshot_retrieval":
        from leaf_tpu_torch.benchmark.zeroshot_retrieval import (
            evaluate_zeroshot_retrieval)
        metrics = evaluate_zeroshot_retrieval(
            module, cfg, tokenizer, ds.image_batches(), ds.text, ds.img2txt,
            recall_ks=tuple(args.recall_k), seconds=seconds)
    elif task == "image_caption_selection":
        from leaf_tpu_torch.benchmark.image_caption_selection import (
            evaluate_image_caption_selection)
        metrics = evaluate_image_caption_selection(module, cfg, tokenizer,
                                                   ds, seconds=seconds)
    elif task == "linear_probe":
        from leaf_tpu_torch.benchmark.linear_probe import (
            evaluate_linear_probe)
        from leaf_tpu_torch.data.imagenet import ImageFolderDataset
        root = args.dataset_root.format(dataset=dataset_name,
                                        language=args.language)
        train_ds = ImageFolderDataset(os.path.join(root, "train"),
                                      preprocess,
                                      batch_size=args.batch_size)
        test_ds = ImageFolderDataset(
            os.path.join(root, args.split if os.path.isdir(
                os.path.join(root, args.split)) else "val"),
            preprocess, batch_size=args.batch_size)
        metrics = evaluate_linear_probe(
            module.visual, cfg, train_ds, test_ds,
            n_classes=len(train_ds.classes), lr=args.fewshot_lr,
            epochs=args.fewshot_epochs, fewshot_k=args.fewshot_k,
            seconds=seconds)
    else:
        raise ValueError(f"unknown task {task}")

    return _emit_result(args, dataset_name, model_name, pretrained, task,
                        metrics)


def _run_captioning(args, dataset_name: str, model_name: str,
                    pretrained: str,
                    seconds: Optional[Dict[str, float]] = None) -> dict:
    """`--task captioning`: the CoCa model (its own registry and weights,
    built here: "build" in `seconds`) captions the dataset's images, in
    `--precision` (fp32 by default, as the JAX command line runs it)."""
    import torch

    from leaf_tpu_torch.benchmark.builder import build_dataset
    from leaf_tpu_torch.benchmark.captioning import evaluate_captioning
    from leaf_tpu_torch.models.coca import create_coca_model
    from leaf_tpu_torch.models.factory import (PRECISIONS, get_tokenizer,
                                               local_checkpoint)
    from leaf_tpu_torch.models.preprocess import image_transform

    if args.precision not in PRECISIONS:
        raise ValueError(f"--precision {args.precision!r}: one of "
                         f"{sorted(PRECISIONS)}")
    clock = seconds if seconds is not None else {}
    t0 = time.perf_counter()
    model = create_coca_model(
        model_name, local_checkpoint(pretrained or None, "--pretrained",
                                     model_name),
        seed=args.seed, device=args.device)
    model.set_compute_dtype(PRECISIONS[args.precision])
    clock["build"] = clock.get("build", 0.0) + time.perf_counter() - t0
    # the model's tokenizer: CoCa's text context is 76
    tokenizer = get_tokenizer(model_name)
    ds, _, _, _ = build_dataset(
        dataset_name, args.dataset_root,
        image_transform(model.cfg.vision.image_size, do_normalize=False),
        split=args.split, batch_size=args.batch_size,
        language=args.language, annotation_file=args.annotation_file)
    metrics = evaluate_captioning(
        model, tokenizer, _captioning_batches(ds),
        generation_type=args.generation_type,
        generator=torch.Generator(device=args.device).manual_seed(args.seed),
        seconds=clock)
    return _emit_result(args, dataset_name, model_name, pretrained,
                        "captioning", metrics)


def _captioning_batches(ds):
    """(images, per-image caption lists) batches of a retrieval-style
    dataset (`image_batches`, `text`, `img2txt`)."""
    img_id = 0
    for images in ds.image_batches():
        refs = []
        for _ in range(len(images)):
            refs.append([ds.text[t] for t in ds.img2txt[img_id]])
            img_id += 1
        yield images, refs


def _emit_result(args, dataset_name: str, model_name: str, pretrained: str,
                 task: str, metrics: dict) -> dict:
    result = {"model": model_name, "pretrained": pretrained,
              "task": task, "dataset": dataset_name,
              "language": args.language, "metrics": metrics}
    if task == "zeroshot_classification" and args.attack:
        # only the classification task runs the attack: stamping attack
        # metadata on other tasks would present clean numbers as robust
        result.update({"attack": args.attack, "eps": args.eps,
                       "iterations_adv": args.attack_iters})
    else:
        result["attack"] = "none"
    if args.output:
        out = args.output.format(dataset=dataset_name.replace("/", "-"),
                                 model=model_name.replace("/", "-"),
                                 pretrained=os.path.basename(
                                     pretrained or "scratch"),
                                 task=task, language=args.language)
        with open(out, "w") as f:
            json.dump(result, f, indent=2, default=float)
        LOG.info("wrote %s", out)
    print(json.dumps(result, default=float))
    return result


def run_eval(args, seconds: Optional[Dict[str, float]] = None) -> List[dict]:
    from leaf_tpu_torch.benchmark.model_collection import expand_models
    models = expand_models(args.model, args.pretrained)
    if len(models) > 1 and args.output and "{model}" not in args.output \
            and "{pretrained}" not in args.output:
        # without a model placeholder every model would overwrite the same
        # result file
        head, tail = os.path.split(args.output)
        args.output = os.path.join(head, "{model}_{pretrained}_" + tail)
        LOG.warning("multiple models with a model-less --output template; "
                    "using %s", args.output)
    clock = seconds if seconds is not None else {}
    out = []
    for (m, p) in models:
        loaded = None
        if args.task != "captioning":
            t0 = time.perf_counter()
            loaded = _load_model(args, m, p)
            clock["build"] = clock.get("build", 0.0) \
                + time.perf_counter() - t0
        out.extend(run_one(args, name, m, p, loaded=loaded, seconds=clock)
                   for name in _expand_datasets(args.dataset))
    return out


META = ["model", "pretrained", "task", "dataset", "language", "attack", "eps",
        "iterations_adv"]


def run_build(args):
    """Merge result JSONs into one CSV, one row per file."""
    rows = []
    fields: List[str] = list(META)
    for path in args.files:
        with open(path) as f:
            r = json.load(f)
        row = {k: r.get(k) for k in META}
        for k, v in r.get("metrics", {}).items():
            row[k] = v
            if k not in fields:
                fields.append(k)
        rows.append(row)
    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    LOG.info("wrote %s (%d rows)", args.output, len(rows))
    return rows


def _column(values: List[str]):
    """A CSV column's cells as pandas's `read_csv` types them: ints, or
    floats (an empty cell is NaN), or strings; with their formatter."""
    def parse(kind):
        out = []
        for v in values:
            if v == "":
                if kind is int:
                    raise ValueError
                out.append(math.nan if kind is float else None)
            else:
                out.append(kind(v))
        return out
    for kind in (int, float):
        try:
            return parse(kind), repr
        except ValueError:
            continue
    return parse(str), str


def run_reformat(args):
    """Pivot a merged CSV into a models x datasets table of top-1 in %
    (acc1 x 100 rounded to 2 places, the `wds/` and `wds/vtab/` prefixes
    stripped, rows indexed by model, pretrained, attack, eps and
    iterations_adv, the mean where an index and dataset repeat), as the
    JAX command line's pandas `pivot_table`, with the rows it drops kept:
    those with an empty index cell."""
    import re

    import numpy as np

    with open(args.input, newline="") as f:
        reader = csv.DictReader(f)
        table = {k: [] for k in reader.fieldnames}
        for row in reader:
            for k in table:
                table[k].append(row[k])
    index_cols = [c for c in ("model", "pretrained", "attack", "eps",
                              "iterations_adv") if c in table]
    cols = {c: _column(table[c]) for c in index_cols}
    acc = np.round(np.asarray(_column(table["acc1"])[0], np.float64) * 100,
                   2)
    datasets = [re.sub(r"^(wds/vtab/|wds/)", "", d)
                for d in table["dataset"]]
    groups: Dict[tuple, Dict[str, List[float]]] = {}
    for i, d in enumerate(datasets):
        key = tuple(cols[c][0][i] for c in index_cols)
        groups.setdefault(key, {}).setdefault(d, []).append(acc[i])

    def missing(v):
        return v is None or (isinstance(v, float) and math.isnan(v))

    def sort_key(key):
        # pandas sorts the groups by their keys, empty cells last
        return tuple((missing(v), "" if missing(v) else v) for v in key)

    columns = sorted({d for per in groups.values() for d in per
                      if any(not math.isnan(a) for a in per[d])})
    lines = [index_cols + columns]
    for key in sorted(groups, key=sort_key):
        if all(math.isnan(a) for per in groups[key].values() for a in per):
            continue      # a row with no top-1 at all (retrieval, probes)
        cells = ["" if missing(v) else cols[c][1](v)
                 for c, v in zip(index_cols, key)]
        for d in columns:
            vals = [a for a in groups[key].get(d, []) if not math.isnan(a)]
            cells.append(repr(float(np.mean(vals))) if vals else "")
        lines.append(cells)
    with open(args.output, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(lines)
    with open(args.output) as f:
        text = f.read()
    print(text)
    LOG.info("wrote %s", args.output)
    return lines


def main(argv: List[str] | None = None,
         seconds: Optional[Dict[str, float]] = None):
    """`seconds`, if given, gains the eval's part seconds: "build" (model
    creation) and each task's parts."""
    p = argparse.ArgumentParser("leaf_tpu_torch benchmark")
    sub = p.add_subparsers(dest="command", required=True)
    e = sub.add_parser("eval")
    e.add_argument("--model", required=True, nargs="+",
                   help="model name(s), `model,pretrained` pairs, a "
                        "collection (openclip_base, openai, leaf, fare, "
                        "openclip_all), or a .txt file of pairs")
    e.add_argument("--pretrained", default="")
    e.add_argument("--model-type", default="open_clip",
                   choices=["open_clip", "hf_clip", "ja_clip"],
                   help="model loading route: open_clip = the native "
                        "factory; hf_clip (an HF repo id as --model) and "
                        "ja_clip are not ported")
    e.add_argument("--precision", default="fp32",
                   help="fp32 (the default, as the JAX benchmark computes) "
                        "or bf16: the towers' compute dtype")
    e.add_argument("--task", default="auto",
                   choices=["auto", "zeroshot_classification",
                            "zeroshot_retrieval", "linear_probe",
                            "image_caption_selection", "captioning"])
    e.add_argument("--dataset", nargs="+", default=["imagefolder"],
                   help="dataset name(s), a collection (vtab, retrieval, "
                        "imagenet_robustness, sugar_crepe), or a .txt list")
    e.add_argument("--dataset-root", required=True,
                   help="root dir; may template {dataset}/{language}")
    e.add_argument("--split", default="test")
    e.add_argument("--language", default="en")
    e.add_argument("--annotation-file", default="")
    e.add_argument("--batch-size", type=int, default=64)
    e.add_argument("--recall-k", type=int, nargs="+", default=[1, 5, 10])
    e.add_argument("--attack", default=None, choices=[None, "apgd"])
    e.add_argument("--eps", type=float, default=2.0, help="/255 units")
    e.add_argument("--attack-iters", type=int, default=100)
    e.add_argument("--interpolate", action="store_true", default=False,
                   help="interpolate the weights with --interpolate-ckpt")
    e.add_argument("--beta", type=float, default=0.5,
                   help="interpolation weight (0 = the other model)")
    e.add_argument("--interpolate-ckpt", default="")
    e.add_argument("--fewshot-k", type=int, default=-1)
    e.add_argument("--fewshot-lr", type=float, default=0.1)
    e.add_argument("--fewshot-epochs", type=int, default=100)
    e.add_argument("--generation-type", default="beam_search",
                   choices=["beam_search", "top_k"],
                   help="captioning: group beam search (the default, as "
                        "the JAX command line runs it) or the greedy loop")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--output", default=None,
                   help="may template {dataset}/{model}/{task}/{language}")
    e.add_argument("--device", default="cuda",
                   help="torch device of the run: 'cuda' (the default) or "
                        "'cpu'")
    b = sub.add_parser("build")
    b.add_argument("files", nargs="+")
    b.add_argument("--output", default="benchmark.csv")
    r = sub.add_parser("reformat")
    r.add_argument("input")
    r.add_argument("--output", default="pivoted.csv")
    args = p.parse_args(argv)
    setup_logging()
    if args.command == "eval":
        return run_eval(args, seconds)
    if args.command == "reformat":
        return run_reformat(args)
    return run_build(args)


if __name__ == "__main__":
    main()
