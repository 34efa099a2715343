"""Contrastive CLIP training command line (port of
`leaf_tpu/train/contrastive_driver.py`):

    python -m leaf_tpu_torch.train.contrastive_driver --model ViT-B-32 \\
        --train-data '/data/shards/{00000..00999}.tar' --batch-size 256 \\
        --precision bf16 --lr 5e-4 --wd 0.2 --local-loss

Both towers train (bf16 compute on fp32 master weights with `--precision
bf16`) on symmetric InfoNCE, or the sigmoid loss with `--siglip`;
`--distill-model` adds the distillation term from a frozen teacher;
`--accum-freq k` takes the feature-cache step, so that every microbatch
sees the whole effective batch as negatives; `--lock-image` /
`--lock-text` lock towers LiT-style (`train.locking`);
`--force-patch-dropout` drops patch tokens at train time.  Train images go
through the random-resized-crop pipeline (`--aug-cfg`); `--val-data` gives
the val loss and recall metrics after every epoch and before the first,
`--imagenet-val` the clean zero-shot top-1/top-5.  Checkpoints are
`checkpoints/epoch_<N>/state.pt` (the model's fp32 `state_dict`, the
optimizer's state and the step) and `--resume latest` continues from the
newest; `results.csv` has one row per epoch.  It runs on `--device`
(default `cuda`).

Against the JAX command line: one card, so `--local-loss` is the global
loss and the features are never gathered; `--grad-checkpointing`, which
the JAX driver ignores, raises.
`--copy-codebase`, `--remote-sync` and `--report-to` act as in the JAX
driver (`utils.file_utils`, `utils.trackers`); `--profile-dir` traces
batches 2 to 5 of epoch 0 and `--matmul-precision` sets torch's fp32
matmul precision, as in the LEAF driver (the JAX contrastive driver
parses both and reads neither).  Flags whose code is not ported raise,
naming where ROADMAP.md queues them: CoCa model names, registry
`--pretrained` tags, the other `--force-*` and `--image-*` overrides,
`--mesh-shape`; `--no-gather-with-grad` raises as in JAX.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from leaf_tpu_torch.data import get_data
from leaf_tpu_torch.data.imagenet import get_imagenet
from leaf_tpu_torch.evals.zero_shot import imagenet_zero_shot_clean
from leaf_tpu_torch.models.clip import CLIP
from leaf_tpu_torch.models.factory import (create_model,
                                           create_model_and_transforms,
                                           get_tokenizer, local_checkpoint)
from leaf_tpu_torch.models.loss import distill_clip_loss
from leaf_tpu_torch.models.preprocess import AugmentationCfg, image_transform
from leaf_tpu_torch.train import checkpoint as ckpt
from leaf_tpu_torch.train.contrastive import (
    ContrastiveState, apply_update, evaluate_contrastive, fp32_features,
    make_accum_contrastive_train_step, make_contrastive_train_step,
    step_metrics)
from leaf_tpu_torch.train.locking import lock_multipliers
from leaf_tpu_torch.train.optim import make_optimizer
from leaf_tpu_torch.train.params import parse_args, set_matmul_precision
from leaf_tpu_torch.train.schedules import make_scheduler
from leaf_tpu_torch.utils.file_utils import copy_codebase, start_run_mirror
from leaf_tpu_torch.utils.logging_utils import setup_logging
from leaf_tpu_torch.utils.meters import AverageMeter
from leaf_tpu_torch.utils.profiler import TraceWindow
from leaf_tpu_torch.utils.results import ResultsLedger
from leaf_tpu_torch.utils.trackers import create_tracker

LOG = logging.getLogger(__name__)

RESULT_COLUMNS = [
    "epoch", "train_loss", "clip_val_loss",
    "image_to_text_R@1", "image_to_text_R@5",
    "text_to_image_R@1", "text_to_image_R@5",
    "imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5",
]


def _not_ported(args) -> None:
    """Raise on every flag whose code the port does not have yet."""
    checks = [
        ("coca" in args.model.lower(), f"the CoCa model {args.model!r}",
         "Queue 1 item 11"),
        (args.mesh_shape, "--mesh-shape (multiple GPUs)", "Queue 1 item 6"),
        (args.force_quick_gelu or args.force_image_size is not None
         or args.image_mean or args.image_std or args.image_interpolation
         or args.image_resize_mode,
         "--force-quick-gelu / --force-image-size / --image-* model "
         "overrides (models/factory.py)", "Queue 1 item 11"),
    ]
    for hit, what, where in checks:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to leaf_tpu_torch yet: ROADMAP {where}")
    if not args.gather_with_grad:
        raise ValueError("--no-gather-with-grad: the features are never "
                         "gathered without their gradient")
    if args.grad_checkpointing:
        raise ValueError("--grad-checkpointing: the contrastive step keeps "
                         "every block's activations (the JAX driver ignores "
                         "the flag)")


def make_distill_train_step(teacher: CLIP) -> Callable:
    """step(state, images, tokens) -> (state, metrics {loss, logit_scale}):
    InfoNCE plus the distillation term from the frozen `teacher`'s
    features on the same batch (no gradient)."""

    def step_fn(state: ContrastiveState, images: torch.Tensor,
                tokens: torch.Tensor):
        img_f, txt_f, scale = fp32_features(state.model(images, tokens))
        with torch.no_grad():
            t_img, t_txt, t_scale = fp32_features(teacher(images, tokens))
        contrastive, distill = distill_clip_loss(img_f, txt_f, scale, t_img,
                                                 t_txt, t_scale)
        loss = contrastive + distill
        loss.backward()
        apply_update(state)
        return state, step_metrics(state, loss)

    return step_fn


def _batch_iter(loader, accum_freq: int) -> Iterator:
    """Group `accum_freq` loader batches into one ([k, b, ...] images,
    k caption lists); a last incomplete group is dropped."""
    if accum_freq <= 1:
        yield from loader
        return
    images_acc, texts_acc = [], []
    for images, texts in loader:
        images_acc.append(np.asarray(images))
        texts_acc.append(list(texts))
        if len(images_acc) == accum_freq:
            yield np.stack(images_acc), texts_acc
            images_acc, texts_acc = [], []


def _timed_batches(it: Iterator, waits: list) -> Iterator:
    """`it`, with the host seconds spent waiting for each item appended to
    `waits`."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t0)
        yield item


def main(args=None) -> Dict:
    if args is None or isinstance(args, list):
        args = parse_args(args)
    setup_logging(level=logging.DEBUG if args.debug else logging.INFO)
    _not_ported(args)
    set_matmul_precision(args.matmul_precision)
    device = torch.device(args.device)

    run_name = args.name or ((args.custom_out_folder or "")
                             + time.strftime("contrastive-%Y_%m_%d-%H_%M_%S"))
    out_dir = os.path.join(args.logs, run_name)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(out_dir, exist_ok=True)
    setup_logging(log_file=os.path.join(out_dir, "out.log"),
                  level=logging.DEBUG if args.debug else logging.INFO)
    LOG.info("contrastive run: %s -> %s on %s", run_name, out_dir, device)
    if args.copy_codebase:
        copy_codebase(out_dir)
    sync_thread = start_run_mirror(args, out_dir, run_name)

    precision = "bf16" if args.precision in ("bf16", "amp") else "fp32"
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    # the contrastive pipeline always random-resized-crops at train time;
    # parse() turns the flag's dict, possibly empty, into the default cfg
    model, preprocess_train, preprocess_val = create_model_and_transforms(
        args.model, local_checkpoint(args.pretrained, "--pretrained"),
        precision=precision, seed=args.seed, device=device,
        master_weights=True, force_patch_dropout=args.force_patch_dropout,
        aug_cfg=AugmentationCfg.parse(args.aug_cfg or None))
    cfg, module = model.cfg, model.module
    # both towers compute in the run's dtype on fp32 master weights
    module.visual.compute_dtype = dtype
    tokenizer = get_tokenizer(args.model)

    teacher = None
    if args.distill_model:
        teacher = create_model(
            args.distill_model,
            local_checkpoint(args.distill_pretrained, "--distill-pretrained"),
            precision=precision, seed=args.seed, device=device)
        teacher.module.requires_grad_(False)
        if teacher.cfg.vision.image_size != cfg.vision.image_size:
            raise ValueError(
                f"--distill-model resolution "
                f"{teacher.cfg.vision.image_size} != student train "
                f"resolution {cfg.vision.image_size}; the teacher receives "
                "the student's batches: pick models at the same resolution")
        if args.siglip:
            raise ValueError("--distill-model is incompatible with --siglip")
        if args.accum_freq > 1:
            raise ValueError("--distill-model with --accum-freq > 1 is "
                             "unsupported")

    # normalised images for training and val; the ImageNet split stays
    # un-normalised, the zero-shot eval normalises on the card
    imagenet_val, args.imagenet_val = args.imagenet_val, None
    data = get_data(args, preprocess_train, preprocess_val=preprocess_val)
    args.imagenet_val = imagenet_val
    if imagenet_val:
        data["imagenet-val"] = get_imagenet(
            imagenet_val, image_transform(cfg.vision.image_size,
                                          do_normalize=False),
            "val", args.batch_size, n_val=args.n_val_imagenet,
            seed=args.seed)
    if "train" not in data:
        raise ValueError("contrastive training needs --train-data or "
                         "--dataset-type synthetic")

    steps_per_epoch = data["train"].num_batches // args.accum_freq
    total_steps = steps_per_epoch * args.epochs
    schedule = make_scheduler(
        "const" if args.skip_scheduler else args.lr_scheduler,
        args.lr, args.warmup, max(total_steps, 1),
        cooldown_steps=(args.epochs_cooldown or 0) * steps_per_epoch,
        cooldown_power=args.lr_cooldown_power,
        cooldown_end_lr=args.lr_cooldown_end)
    multipliers = None
    if args.lock_image or args.lock_text:
        multipliers = lock_multipliers(
            module, lock_image=bool(args.lock_image),
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text,
            lock_text_unlocked_layers=args.lock_text_unlocked_layers,
            lock_text_freeze_layer_norm=args.lock_text_freeze_layer_norm)
        LOG.info("tower locking: image=%s (unlocked_groups=%d) text=%s "
                 "(unlocked_layers=%d): %d of %d parameters locked",
                 bool(args.lock_image), args.lock_image_unlocked_groups,
                 args.lock_text, args.lock_text_unlocked_layers,
                 sum(v == 0.0 for v in multipliers.values()),
                 len(multipliers))
    optimizer = make_optimizer(
        module.named_parameters(), schedule, weight_decay=args.wd,
        beta1=args.beta1, beta2=args.beta2, eps=args.eps,
        grad_clip_norm=args.grad_clip_norm, multipliers=multipliers)
    state = ContrastiveState(module, optimizer)

    if teacher is not None:
        step_fn = make_distill_train_step(teacher.module)
    elif args.accum_freq > 1:
        # the feature-cache step computes InfoNCE without patch dropout
        if args.siglip:
            raise ValueError("--siglip with --accum-freq > 1 is unsupported "
                             "(the feature-cache accumulation computes the "
                             "InfoNCE loss)")
        if cfg.vision.patch_dropout > 0:
            raise ValueError("--force-patch-dropout with --accum-freq > 1 "
                             "is unsupported")
        step_fn = make_accum_contrastive_train_step()
    else:
        step_fn = make_contrastive_train_step(
            args.siglip, args.seed + 17 if cfg.vision.patch_dropout > 0
            else None)

    tracker = create_tracker(args.report_to, out_dir, run_name,
                             wandb_project=args.wandb_project_name,
                             wandb_notes=args.wandb_notes, config=vars(args))
    start_epoch = 0
    resume = ckpt.resolve_resume(args.resume, ckpt_dir)
    results = ResultsLedger(os.path.join(out_dir, "results.csv"),
                            columns=RESULT_COLUMNS, fresh=resume is None)
    if resume is not None:
        epoch_done, path = resume
        LOG.info("resuming from %s (epoch %d)", path, epoch_done)
        payload = ckpt.load_checkpoint(path, map_location=device)
        module.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        start_epoch = epoch_done
        results.truncate_to_epoch(epoch_done)

    def save(epoch: int) -> None:
        ckpt.save_checkpoint(ckpt_dir, epoch, {
            "model": module.state_dict(),
            "optimizer": optimizer.state_dict(), "step": state.step})

    def run_eval(epoch: int) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        if "val" in data:
            metrics.update(evaluate_contrastive(module, data["val"].loader,
                                                tokenizer))
        if "imagenet-val" in data and args.zeroshot_frequency and (
                epoch % args.zeroshot_frequency == 0
                or epoch == args.epochs):
            metrics.update(imagenet_zero_shot_clean(
                module, cfg, data["imagenet-val"], tokenizer))
        return metrics

    def record(epoch: int, train_loss: float, metrics: Dict[str, float]):
        row = {"epoch": epoch, "train_loss": train_loss}
        for col in RESULT_COLUMNS[2:]:
            if col in metrics:
                row[col] = metrics[col]
        results.append(row)
        tracker.log({f"val/{k}": v for k, v in metrics.items()
                     if isinstance(v, (int, float))}, step=epoch)

    if start_epoch == 0:
        metrics = run_eval(0)
        if metrics:
            LOG.info("epoch 0 eval: %s", metrics)
        record(0, float("nan"), metrics)

    # per step: the host's wait for the batch, and (on a card) the step's
    # device seconds from CUDA events, read at the end of the epoch
    times = []
    ctx = cfg.text.context_length
    for epoch in range(start_epoch, args.epochs):
        LOG.info("Start epoch %d", epoch)
        info = data["train"]
        info.set_epoch(epoch)
        losses_m = AverageMeter()
        batch_time_m = AverageMeter()
        waits, events = [], []
        trace = TraceWindow(args.profile_dir, epoch)
        end = time.time()
        for i, (images, texts) in enumerate(_timed_batches(
                _batch_iter(info.loader, args.accum_freq), waits)):
            trace.step(i)
            if args.accum_freq > 1:
                tokens = np.stack([tokenizer(t, context_length=ctx)
                                   for t in texts])
            else:
                tokens = tokenizer(texts, context_length=ctx)
            images_d = torch.from_numpy(np.ascontiguousarray(images)).to(
                device)
            tokens_d = torch.from_numpy(tokens).to(device)
            if device.type == "cuda":
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            state, metrics = step_fn(state, images_d, tokens_d)
            if events:
                events[-1][1].record()
            batch_time_m.update(time.time() - end)
            end = time.time()
            if (i + 1) % args.log_every_n_steps == 0 \
                    or i + 1 == steps_per_epoch:
                # the train loss is the mean of the logged steps' losses,
                # as in the JAX driver
                loss_val = float(metrics["loss"])
                losses_m.update(loss_val)
                sps = args.batch_size * args.accum_freq / batch_time_m.val
                LOG.info("Contrastive Epoch %d [%d/%d] loss %.5g (%.5g) "
                         "%.1f samples/s", epoch, i + 1, steps_per_epoch,
                         loss_val, losses_m.avg, sps)
                tracker.log({"train/loss": loss_val,
                             "train/samples_per_second": sps},
                            step=state.step)
        trace.close()
        if events:
            events[-1][1].synchronize()
        for k, wait in enumerate(waits):
            times.append({"epoch": epoch, "wait_s": wait, "device_s": (
                events[k][0].elapsed_time(events[k][1]) / 1e3
                if events else None)})
        completed = epoch + 1
        metrics = run_eval(completed)
        if metrics:
            LOG.info("epoch %d eval: %s", completed, metrics)
        record(completed, losses_m.avg if losses_m.count else float("nan"),
               metrics)
        if completed % args.save_frequency == 0 or completed == args.epochs:
            save(completed)

    ckpt.wait_for_checkpoints()
    if sync_thread is not None:
        sync_thread.stop(final_sync=True)
    tracker.finish()
    return {"results": results.rows, "state": state, "model": model,
            "cfg": cfg, "out_dir": out_dir, "times": times}


if __name__ == "__main__":
    main()
