"""LEAF training driver (port of `leaf_tpu/train/driver.py`):

    python -m leaf_tpu_torch.train.driver --model ViT-L-14-quickgelu \\
        --dataset-type synthetic --precision bf16 --batch-size 128 --rho 50

Wires the pieces: model and frozen anchor tower, optimizer with the
weight-decay mask and schedule, data, the epochs loop and the
`results.csv` / `times_False.csv` ledgers.  It runs on `--device`
(default `cuda`).  See `scripts/train_leaf_vitl.sh` for the recipes.

Against the JAX driver: the frozen anchor tower is a deep copy of the
text tower made before training; bf16 runs keep fp32 master weights and
compute in bf16; the step is the unfused one of `train.loop`.  Flags
whose code is not ported yet raise, naming where ROADMAP.md queues them;
none is ignored.
"""
from __future__ import annotations

import copy
import datetime
import logging
import os
from typing import Dict

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.data.synthetic import get_synthetic_dataset
from leaf_tpu_torch.models.factory import create_model, get_tokenizer
from leaf_tpu_torch.train.loop import train_one_epoch_text_only
from leaf_tpu_torch.train.optim import make_optimizer
from leaf_tpu_torch.train.params import parse_args
from leaf_tpu_torch.train.schedules import make_scheduler
from leaf_tpu_torch.train.step import (TrainState, make_anchor_encode,
                                       make_train_step)
from leaf_tpu_torch.utils.logging_utils import setup_logging
from leaf_tpu_torch.utils.results import ResultsLedger, TimingLedger

LOG = logging.getLogger(__name__)

RESULT_COLUMNS = [
    "epoch", "train_loss",
    "imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5",
    "imagenet-zeroshot-val-top1-adv",
    "agnews-zeroshot-train-acc", "agnews-zeroshot-train-acc-adv",
    "sst2-zeroshot-train-acc", "sst2-zeroshot-train-acc-adv",
]


def build_run_name(args) -> str:
    """Run folder name under --logs.  `--custom_out_folder` is a name
    prefix, not an alternative logs root."""
    if args.name:
        return args.name
    prefix = getattr(args, "custom_out_folder", None) or ""
    now = datetime.datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
    return (f"{prefix}{now}-model_{args.model.replace('/', '-')}-lr_{args.lr}-"
            f"b_{args.batch_size}-rho_{args.rho}-k_{args.k_adv}")


def _not_ported(args) -> None:
    """Raise on every flag whose code the port does not have yet."""
    checks = [
        (args.constrain, "--constrain (attacks/constraint.py)",
         "'Next, in order' item 1"),
        (args.use_charmer, "--use_charmer (the batched charmer attack)",
         "Queue 1 item 8"),
        (args.resume, "--resume (train/checkpoint.py)",
         "'Next, in order' item 2"),
        (args.save_most_recent or args.delete_previous_checkpoint,
         "--save-most-recent / --delete-previous-checkpoint "
         "(train/checkpoint.py)", "'Next, in order' item 2"),
        (args.accum_freq != 1, "--accum-freq > 1",
         "'Next, in order' item 3"),
        (args.zeroshot_frequency != 0,
         "--zeroshot-frequency other than 0 (evals/zero_shot.py)",
         "Queue 1 item 7"),
        (args.val_data or args.val_text_classification or args.imagenet_val
         or args.imagenet_v2,
         "--val-data / --val-text-classification / --imagenet-val / "
         "--imagenet-v2 (evals)", "Queue 1 item 7"),
        (args.dataset_type != "synthetic",
         f"--dataset-type {args.dataset_type} (data/wds.py, data/csv_data.py)"
         ": pass --dataset-type synthetic", "'Next, in order' item 5"),
        (args.remote_sync or args.copy_codebase,
         "--remote-sync / --copy-codebase (utils/file_utils.py)",
         "'Next, in order' item 5"),
        (args.report_to, "--report-to (utils/trackers.py)",
         "'Next, in order' item 5"),
        (args.profile_dir, "--profile-dir", "'Next, in order' item 5"),
        (args.mesh_shape, "--mesh-shape (multiple GPUs)", "Queue 1 item 6"),
        (args.matmul_precision, "--matmul-precision",
         "'Next, in order' item 5"),
        (args.force_quick_gelu or args.force_patch_dropout is not None
         or args.force_image_size is not None or args.image_mean
         or args.image_std or args.image_interpolation
         or args.image_resize_mode,
         "--force-* / --image-* model overrides (models/factory.py)",
         "Queue 1 item 11"),
        (args.pretrained and not os.path.exists(args.pretrained),
         f"--pretrained {args.pretrained!r}: registry tags and hub ids "
         "(models/pretrained.py); pass a local checkpoint",
         "Queue 1 item 11"),
    ]
    for hit, what, where in checks:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to leaf_tpu_torch yet: ROADMAP {where}")


def main(args=None) -> Dict:
    if args is None or isinstance(args, list):
        args = parse_args(args)
    setup_logging(level=logging.DEBUG if args.debug else logging.INFO)
    _not_ported(args)
    # flags that belong to the vanilla contrastive trainer are a hard
    # error here
    if args.siglip or args.distill_model or args.local_loss:
        raise ValueError(
            "--siglip/--distill-model/--local-loss drive the contrastive "
            "pretrainer, not LEAF text-only adversarial training")
    if args.aug_cfg:
        # text-only training discards train images, so augmentation could
        # only ever silently do nothing here
        raise ValueError(
            "--aug-cfg has no effect on LEAF text-only AT (train images "
            "are discarded); it drives the contrastive pretrainer")
    if args.lock_image is False:   # None (default) = locked
        raise ValueError("LEAF text-AT always locks the vision tower")
    device = torch.device(args.device)

    run_name = build_run_name(args)
    out_dir = os.path.join(args.logs, run_name)
    os.makedirs(out_dir, exist_ok=True)
    setup_logging(log_file=os.path.join(out_dir, "out.log"),
                  level=logging.DEBUG if args.debug else logging.INFO)
    LOG.info("run: %s -> %s on %s", run_name, out_dir, device)

    # model + frozen anchor tower -----------------------------------------
    precision = "bf16" if args.precision in ("bf16", "amp") else "fp32"
    model = create_model(args.model, args.pretrained or None,
                         precision=precision, seed=args.seed, device=device,
                         master_weights=True)
    cfg = model.cfg
    text = model.module.text
    # the frozen anchor tower: a copy of the initial text tower that no
    # optimizer ever sees
    frozen_text = copy.deepcopy(text).requires_grad_(False)

    vocab = edits.DEFAULT_VOCAB
    scorer = CandidateScorer(cfg, device)
    tokenizer = get_tokenizer(args.model)

    # data ----------------------------------------------------------------
    data = {"train": get_synthetic_dataset(
        args.train_num_samples or 100, args.batch_size,
        image_size=cfg.vision.image_size, seed=args.seed)}

    # optimizer ------------------------------------------------------------
    steps_per_epoch = data["train"].num_batches // args.accum_freq
    total_steps = steps_per_epoch * args.epochs
    schedule = make_scheduler(
        "const" if args.skip_scheduler else args.lr_scheduler,
        args.lr, args.warmup, max(total_steps, 1),
        cooldown_steps=(args.epochs_cooldown or 0) * steps_per_epoch,
        cooldown_power=args.lr_cooldown_power,
        cooldown_end_lr=args.lr_cooldown_end)
    optimizer = make_optimizer(
        text.named_parameters(), schedule, weight_decay=args.wd,
        beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        grad_clip_norm=args.grad_clip_norm, accum_freq=args.accum_freq)
    state = TrainState.create(text, optimizer)

    train_step = make_train_step(normalize=args.normalize_fare,
                                 remat=args.grad_checkpointing,
                                 w_fare_text=args.w_fare_text)
    anchor_encode = make_anchor_encode(normalize=args.normalize_fare)

    results = ResultsLedger(os.path.join(out_dir, "results.csv"),
                            columns=RESULT_COLUMNS, fresh=True)
    timing = TimingLedger(os.path.join(out_dir,
                                       f"times_{args.use_charmer}.csv"))

    def record(epoch: int, train_loss: float, metrics: Dict[str, float]):
        row = {"epoch": epoch, "train_loss": train_loss}
        for col in RESULT_COLUMNS[2:]:
            if col in metrics:
                row[col] = metrics[col]
        results.append(row)

    # epoch-0 snapshot: the in-training evals are not ported, so the row
    # holds the epoch and the reference's train_loss=-1 only
    record(0, -1.0, {})

    seconds: Dict[str, float] = {}
    for epoch in range(args.epochs):
        LOG.info("Start epoch %d", epoch)
        state, log_data = train_one_epoch_text_only(
            state, frozen_text, scorer, anchor_encode, train_step,
            tokenizer, vocab, data, epoch, args, timing=timing,
            rng=np.random.default_rng(args.seed + 1000 * epoch),
            seconds=seconds)
        record(epoch + 1, log_data.get("train/loss", float("nan")), {})

    return {"results": results.rows, "state": state, "model": model,
            "frozen_text": frozen_text, "cfg": cfg, "out_dir": out_dir,
            "attack_times": timing.times, "attack_seconds": seconds}


if __name__ == "__main__":
    main()
