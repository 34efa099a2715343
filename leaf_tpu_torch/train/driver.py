"""LEAF training driver (port of `leaf_tpu/train/driver.py`):

    python -m leaf_tpu_torch.train.driver --model ViT-L-14-quickgelu \\
        --dataset-type synthetic --precision bf16 --batch-size 128 --rho 50

Wires the pieces: model and frozen anchor tower, optimizer with the
weight-decay mask and schedule, data (`data.get_data`: webdataset tars,
CSV or synthetic captions; ImageNet folders; the text-classification
sets), the fused attack+train step (`train.fused.FusedLeafStep`, every
recipe but `--use_charmer`, which takes the unfused loop with the batched
Charmer), the epochs loop, the zero-shot eval before
training and after every epoch (`evals.zero_shot.zero_shot_eval`; with
`--val-data` also the contrastive val loss and recall metrics of
`train.contrastive.evaluate_contrastive`, logged),
checkpoints with `--resume`, the per-save OpenCLIP export and the
`results.csv` / `times_{use_charmer}.csv` ledgers.  It runs on `--device`
(default `cuda`).  See `scripts/train_leaf_vitl.sh` for the recipes.

Against the JAX driver: the frozen anchor tower is a deep copy of the
text tower made before training; bf16 runs keep fp32 master weights and
compute in bf16; a checkpoint is `checkpoints/epoch_<N>/state.pt` (the
text tower's fp32 `state_dict`, the optimizer's state, the step) where
the JAX package writes an Orbax directory.  Flags whose code is not
ported yet raise, naming where ROADMAP.md queues them; none is ignored.

Run management, as in the JAX driver: `--copy-codebase` snapshots the
package into `<run>/code`; `--remote-sync <dir or scheme://...>` mirrors
the run directory (`utils.file_utils`), and `--resume latest` then also
looks for a newer checkpoint in the mirror; `--report-to
tensorboard,wandb` logs each logged step and each eval
(`utils.trackers`); `--profile-dir` writes a `torch.profiler` trace of
batches 2 to 5 of epoch 0 (`utils.profiler.TraceWindow`);
`--matmul-precision` sets torch's fp32 matmul precision
(`train.params.MATMUL_PRECISIONS`).
"""
from __future__ import annotations

import copy
import datetime
import json
import logging
import os
import shutil
from typing import Dict

import numpy as np
import torch

from leaf_tpu_torch.attacks import edits
from leaf_tpu_torch.attacks.constraint import WordConstraint
from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.attacks.image import _normalize_images
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.data import get_data
from leaf_tpu_torch.evals.zero_shot import zero_shot_eval
from leaf_tpu_torch.models.factory import create_model, get_tokenizer
from leaf_tpu_torch.models.preprocess import image_transform
from leaf_tpu_torch.train import checkpoint as ckpt
from leaf_tpu_torch.train.contrastive import evaluate_contrastive
from leaf_tpu_torch.train.fused import FusedLeafStep
from leaf_tpu_torch.train.loop import train_one_epoch_text_only
from leaf_tpu_torch.train.optim import make_optimizer
from leaf_tpu_torch.train.params import parse_args, set_matmul_precision
from leaf_tpu_torch.train.schedules import make_scheduler
from leaf_tpu_torch.train.step import (TrainState, make_anchor_encode,
                                       make_train_step)
from leaf_tpu_torch.utils.file_utils import copy_codebase, start_run_mirror
from leaf_tpu_torch.utils.logging_utils import setup_logging
from leaf_tpu_torch.utils.results import ResultsLedger, TimingLedger
from leaf_tpu_torch.utils.trackers import create_tracker

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
        (args.mesh_shape, "--mesh-shape (multiple GPUs)", "Queue 1 item 6"),
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


def _discover_resume(args, ckpt_dir: str, run_name: str):
    """`--resume`'s (epoch, path); with `--remote-sync` and `--resume
    latest`, a newer checkpoint in the mirror's `<run>/checkpoints` wins
    (the local run directory may be on a fresh machine).  A `scheme://`
    mirror is not searched: checkpoints load from local paths."""
    found = ckpt.resolve_resume(args.resume, ckpt_dir)
    if args.remote_sync and args.resume == "latest":
        remote = os.path.join(args.remote_sync, run_name, "checkpoints")
        if "://" in remote:
            LOG.warning("remote latest-discovery skipped: %s is not a "
                        "local path (checkpoints load locally)", remote)
        elif os.path.isdir(remote):
            newer = ckpt.resolve_resume("latest", remote)
            if newer is not None and (found is None or newer[0] > found[0]):
                found = newer
    return found


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
    if args.remote_sync and args.resume == "latest" \
            and args.save_most_recent:
        raise ValueError(
            "cannot use --save-most-recent with --remote-sync and "
            "--resume latest (reference errors likewise)")
    set_matmul_precision(args.matmul_precision)
    device = torch.device(args.device)

    run_name = build_run_name(args)
    out_dir = os.path.join(args.logs, run_name)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    setup_logging(log_file=os.path.join(out_dir, "out.log"),
                  level=logging.DEBUG if args.debug else logging.INFO)
    LOG.info("run: %s -> %s on %s", run_name, out_dir, device)
    # codebase snapshot and remote mirror: one verified sync pass before
    # training, then a background thread, a final sync at the end
    if args.copy_codebase:
        copy_codebase(out_dir)
    sync_thread = start_run_mirror(args, out_dir, run_name)

    # model + frozen anchor tower -----------------------------------------
    precision = "bf16" if args.precision in ("bf16", "amp") else "fp32"
    model = create_model(args.model, args.pretrained or None,
                         precision=precision, seed=args.seed, device=device,
                         master_weights=True)
    cfg = model.cfg
    text = model.module.text
    # the vision tower is never trained (LEAF text-AT locks it); it is
    # evaluated, and PGD asks for its input's gradient alone
    model.module.visual.requires_grad_(False)
    # the frozen anchor tower: a copy of the initial text tower that no
    # optimizer ever sees
    frozen_text = copy.deepcopy(text).requires_grad_(False)

    vocab = edits.DEFAULT_VOCAB
    constraint = WordConstraint() if args.constrain else None
    scorer = CandidateScorer(cfg, device)
    tokenizer = get_tokenizer(args.model)

    # data ----------------------------------------------------------------
    # attacks operate in pixel space: datasets yield un-normalised images
    preprocess_nonorm = image_transform(cfg.vision.image_size,
                                        do_normalize=False)
    data = get_data(args, preprocess_nonorm, text_only=args.text_only)

    # optimizer ------------------------------------------------------------
    steps_per_epoch = (data["train"].num_batches // args.accum_freq
                       if "train" in data else 0)
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
    fused_step = None
    if not args.use_charmer:
        # the fused path covers every leaf-attack recipe, INCLUDING
        # --constrain (validity masks are applied to the candidate token
        # buffer host-side) and k_adv > 1 (two phases per edit round, the
        # train update fused into the last)
        fused_step = FusedLeafStep(cfg, tokenizer, rho=args.rho, vocab=vocab,
                                   normalize=args.normalize_fare,
                                   remat=args.grad_checkpointing,
                                   constraint=constraint,
                                   objective=args.attack_objective,
                                   w_fare_text=args.w_fare_text,
                                   k=args.k_adv, device=device)

    timing = TimingLedger(os.path.join(out_dir,
                                       f"times_{args.use_charmer}.csv"))
    tracker = create_tracker(args.report_to, out_dir, run_name,
                             wandb_project=args.wandb_project_name,
                             wandb_notes=args.wandb_notes, config=vars(args))

    # resume ---------------------------------------------------------------
    start_epoch = 0
    resume = _discover_resume(args, ckpt_dir, run_name)
    # a run that does not resume starts its ledger anew; a resumed one
    # keeps the rows up to the epoch it resumes from
    results = ResultsLedger(os.path.join(out_dir, "results.csv"),
                            columns=RESULT_COLUMNS, fresh=resume is None)
    if resume is not None:
        epoch_done, path = resume
        LOG.info("resuming from %s (epoch %d)", path, epoch_done)
        payload = ckpt.load_checkpoint(path, map_location=device)
        text.load_state_dict(payload["text"])
        optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        # the frozen anchor tower never changes: it lives in a one-off
        # `frozen` sidecar, not in every epoch payload.  It is looked for
        # in this run's checkpoints, then next to the resumed checkpoint
        # (an explicit --resume into another run's directory), and in the
        # second case saved again as this run's sidecar so that the *next*
        # resume finds it.
        try:
            frozen_sd = ckpt.load_named(ckpt_dir, "frozen")
        except FileNotFoundError:
            frozen_sd = ckpt.load_named(
                os.path.dirname(os.path.abspath(path)), "frozen")
            ckpt.save_named(ckpt_dir, "frozen", frozen_sd)
        frozen_text.load_state_dict(frozen_sd["frozen_text"])
        # checkpoint names record *completed* epochs; training epoch
        # indices are 0-based, so the next epoch to run == epoch_done
        start_epoch = epoch_done
        results.truncate_to_epoch(epoch_done)
    else:
        ckpt.save_named(ckpt_dir, "frozen",
                        {"frozen_text": frozen_text.state_dict()})

    def payload_now() -> Dict:
        return {"text": text.state_dict(),
                "optimizer": optimizer.state_dict(), "step": state.step}

    def export_model(epoch: int) -> None:
        """Full-model OpenCLIP-format export next to the trainer's own
        state: `checkpoints/model_epoch_<N>/open_clip_model.safetensors`
        (+ activation metadata) is what the standalone evals and the JAX
        package's loaders consume; `state.pt` holds only the trained
        text side."""
        out = os.path.join(ckpt_dir, f"model_epoch_{epoch}")
        save_state_dict(params_to_openclip(model.module.state_dict(), cfg),
                        out, "openclip")
        with open(os.path.join(out, "open_clip_config.json"), "w") as f:
            json.dump({"model_cfg": {"quick_gelu": bool(cfg.quick_gelu)}}, f)

    def save(epoch: int) -> None:
        ckpt.save_checkpoint(ckpt_dir, epoch, payload_now())
        export_model(epoch)
        if args.delete_previous_checkpoint:
            # the save above writes on a worker thread: epoch_N must be in
            # place before epoch_{N-1} is deleted, or a crash in between
            # leaves no checkpoint to resume from
            ckpt.wait_for_checkpoints()
            for prev in (os.path.join(ckpt_dir, f"epoch_{epoch - 1}"),
                         os.path.join(ckpt_dir, f"model_epoch_{epoch - 1}")):
                if os.path.isdir(prev):
                    shutil.rmtree(prev)

    eval_seconds: Dict[int, Dict[str, float]] = {}

    def val_batches():
        """--val-data's batches, the images normalised on the device."""
        for images, texts in data["val"].loader:
            yield _normalize_images(
                torch.from_numpy(np.ascontiguousarray(images)).to(device),
                cfg), texts

    def run_eval(epoch: int) -> Dict[str, float]:
        """The zero-shot eval on the current text tower and the frozen
        vision tower, its PGD starts drawn from `seed + epoch`; the val
        metrics every `--val-frequency` epochs and at the last, both
        towers in the run's precision."""
        eval_seconds[epoch] = {}
        metrics = zero_shot_eval(
            model.module, cfg, data, tokenizer, preprocess_nonorm, epoch,
            args, scorer=scorer,
            generator=torch.Generator(device=device).manual_seed(
                args.seed + epoch),
            seconds=eval_seconds[epoch])
        if "val" in data and (epoch % max(args.val_frequency, 1) == 0
                              or epoch == args.epochs):
            metrics.update(evaluate_contrastive(
                model.module, val_batches(), tokenizer,
                dtype=model.module.text.dtype))
        return metrics

    def record(epoch: int, train_loss: float, metrics: Dict[str, float]):
        row = {"epoch": epoch, "train_loss": train_loss}
        for col in RESULT_COLUMNS[2:]:
            if col in metrics:
                row[col] = metrics[col]
        results.append(row)

    def finish() -> None:
        ckpt.wait_for_checkpoints()
        if sync_thread is not None:
            sync_thread.stop(final_sync=True)
        tracker.finish()

    # epoch-0 snapshot; the reference writes train_loss=-1 for it
    if start_epoch == 0:
        metrics = run_eval(0)
        LOG.info("epoch 0 eval: %s", metrics)
        record(0, -1.0, metrics)
        if "train" in data:
            save(0)

    seconds: Dict[str, float] = {}
    if "train" not in data:
        finish()
        return {"results": results.rows, "state": state, "model": model,
                "frozen_text": frozen_text, "cfg": cfg, "out_dir": out_dir,
                "eval_seconds": eval_seconds}
    for epoch in range(start_epoch, args.epochs):
        LOG.info("Start epoch %d", epoch)
        state, log_data = train_one_epoch_text_only(
            state, frozen_text, scorer, anchor_encode, train_step,
            tokenizer, vocab, data, epoch, args, constraint=constraint,
            timing=timing,
            rng=np.random.default_rng(args.seed + 1000 * epoch),
            seconds=seconds, fused_step=fused_step, tracker=tracker)
        completed = epoch + 1
        metrics = run_eval(completed)
        LOG.info("epoch %d eval: %s", completed, metrics)
        record(completed, log_data.get("train/loss", float("nan")), metrics)
        tracker.log({f"val/{k}": v for k, v in metrics.items()
                     if isinstance(v, (int, float))}, step=completed)
        if (args.save_frequency > 0
                and completed % args.save_frequency == 0) \
                or completed == args.epochs:
            save(completed)
        if args.save_most_recent:
            ckpt.save_latest(ckpt_dir, completed, payload_now())

    finish()
    return {"results": results.rows, "state": state, "model": model,
            "frozen_text": frozen_text, "cfg": cfg, "out_dir": out_dir,
            "attack_times": timing.times, "attack_seconds": seconds,
            "fused_step": fused_step, "eval_seconds": eval_seconds}


if __name__ == "__main__":
    main()
