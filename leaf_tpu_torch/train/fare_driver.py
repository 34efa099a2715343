"""FARE training command line (port of `leaf_tpu/train/fare_driver.py`):

    python -m leaf_tpu_torch.train.fare_driver --model ViT-H-14 \\
        --pretrained <checkpoint> --imagenet-root <train folder> \\
        --precision bf16 --batch-size 128 --steps 10000 --warmup 700

(`scripts/train_fare_vith.sh` has the recipe.)  The flags are the JAX
command line's, with `--device` added (default `cuda`); eps and the step
size are in /255 units.  Checkpoints: `<output-dir>/<experiment-name>/
checkpoints/epoch_<step>/state.pt` at 10 milestones and a rolling
`fallback_<step>` every `--fallback-freq` steps (the tower's fp32
parameters, the optimizer's moments and the step); `--resume latest`
continues from the newest of them.  A finished run deletes its fallbacks.

`--report-to tensorboard,wandb` logs every step's metrics
(`utils.trackers`), as the JAX driver does.

Against the JAX command line: `--pretrained` takes a local checkpoint
only; the zero-shot
classifier is built for `--loss ce_reg` too, where the JAX driver builds
it for `ce` alone and then scores `ce_reg` against a one-column zero
classifier.  `--eval-freq` is parsed and read by nothing, as in JAX.
"""
from __future__ import annotations

import argparse
import logging
import os
import re
import shutil
from typing import Optional, Tuple

import torch

from leaf_tpu_torch.attacks.engine import CandidateScorer
from leaf_tpu_torch.data.imagenet import get_imagenet
from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                           local_checkpoint)
from leaf_tpu_torch.models.preprocess import image_transform
from leaf_tpu_torch.models.zero_shot import (build_zero_shot_classifier,
                                             imagenet_classnames,
                                             openai_imagenet_templates,
                                             simple_imagenet_templates)
from leaf_tpu_torch.train import checkpoint as ckpt
from leaf_tpu_torch.train import fare
from leaf_tpu_torch.utils.logging_utils import setup_logging
from leaf_tpu_torch.utils.trackers import create_tracker

LOG = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser("leaf_tpu_torch FARE image adversarial "
                                "training")
    p.add_argument("--model", type=str, default="ViT-L-14")
    p.add_argument("--pretrained", type=str, default="")
    p.add_argument("--imagenet-root", type=str, required=True)
    p.add_argument("--template", type=str, default="ensemble",
                   choices=["ensemble", "std", "simple"])
    p.add_argument("--output-normalize", action="store_true", default=False)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--warmup", type=int, default=700)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--loss", type=str, default="l2")
    p.add_argument("--loss-clean", type=str, default="l2")
    p.add_argument("--clean-weight", type=float, default=0.0)
    p.add_argument("--trades", action="store_true", default=False)
    p.add_argument("--opt", type=str, default="adamw", choices=["adamw", "sgd"])
    p.add_argument("--momentum-sgd", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--attack", type=str, default="pgd",
                   choices=["pgd", "apgd", "none"])
    p.add_argument("--inner-loss", type=str, default="l2")
    p.add_argument("--norm", type=str, default="linf")
    p.add_argument("--eps", type=float, default=2.0, help="in /255 units")
    p.add_argument("--iterations-adv", type=int, default=10)
    p.add_argument("--stepsize-adv", type=float, default=1.0,
                   help="in /255 units")
    p.add_argument("--precision", type=str, default="bf16",
                   help="compute dtype of every encode: bf16 (or amp) or "
                        "fp32; the weights stay fp32")
    p.add_argument("--no-remat", dest="remat", action="store_false",
                   default=True,
                   help="keep every block's activations for the backward "
                        "instead of recomputing them")
    p.add_argument("--output-dir", type=str, default="./fare_out")
    p.add_argument("--experiment-name", type=str, default="FARE")
    p.add_argument("--log-freq", type=int, default=10)
    p.add_argument("--report-to", default="", type=str,
                   help="comma-sep: wandb,tensorboard")
    p.add_argument("--wandb-project-name", type=str, default="clip-finetune")
    p.add_argument("--fallback-freq", type=int, default=20,
                   help="rolling crash-recovery checkpoint cadence in "
                        "steps; 0 disables")
    p.add_argument("--eval-freq", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default="",
                   help="'latest' resumes from the newest fallback or "
                        "milestone checkpoint in the output dir "
                        "(parameters, optimizer moments and step; the data "
                        "stream restarts)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: 'cuda' (the default) or "
                        "'cpu'")
    return p.parse_args(argv)


def _latest_fare_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the newest fallback_<N> or epoch_<N> directory, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.match(r"^(?:fallback|epoch)_(\d+)$", name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, os.path.join(ckpt_dir, name))
    return best


def _remove_fallbacks(ckpt_dir: str, keep: str = "") -> None:
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if name.startswith("fallback_") and name != keep:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    if args.resume and args.resume != "latest":
        raise ValueError("--resume only supports 'latest'")
    # fp32 master weights; the text tower (the classifier) computes in fp32
    # as the JAX driver's scorer does, the vision tower in --precision
    model = create_model(args.model,
                         local_checkpoint(args.pretrained, "--pretrained"),
                         precision="fp32", seed=args.seed, device=args.device,
                         master_weights=True)
    cfg = model.cfg
    visual = model.module.visual
    visual.compute_dtype = (torch.bfloat16 if args.precision in ("bf16", "amp")
                            else torch.float32)

    classifier = None
    if {"ce", "ce_reg"} & {args.loss, args.inner_loss, args.loss_clean}:
        scorer = CandidateScorer(cfg, model.device)
        templates = (openai_imagenet_templates() if args.template == "ensemble"
                     else simple_imagenet_templates())
        classifier = build_zero_shot_classifier(
            lambda t: scorer.encode_text(model.module.text, t),
            get_tokenizer(args.model), imagenet_classnames(), templates)

    preprocess = image_transform(cfg.vision.image_size, do_normalize=False)
    train_info = get_imagenet(args.imagenet_root, preprocess, "train",
                              batch_size=args.batch_size, seed=args.seed)

    def repeat_forever():
        while True:
            yield from train_info.loader

    fcfg = fare.FareConfig(
        steps=args.steps, warmup=args.warmup, batch_size=args.batch_size,
        lr=args.lr, wd=args.wd, opt=args.opt,
        momentum_sgd=args.momentum_sgd, attack=args.attack, norm=args.norm,
        eps=args.eps / 255.0, iterations_adv=args.iterations_adv,
        stepsize_adv=args.stepsize_adv / 255.0, inner_loss=args.inner_loss,
        loss=args.loss, loss_clean=args.loss_clean,
        clean_weight=args.clean_weight, trades=args.trades,
        output_normalize=args.output_normalize, log_freq=args.log_freq,
        eval_freq=args.eval_freq, remat=args.remat,
        fallback_freq=args.fallback_freq)

    out_dir = os.path.join(args.output_dir, args.experiment_name)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    def checkpoint_fn(step, state):
        ckpt.save_checkpoint(ckpt_dir, step, state.payload())

    def fallback_fn(step, state):
        # save fallback_<step>, then remove the earlier one
        ckpt.save_named(ckpt_dir, f"fallback_{step}", state.payload())
        _remove_fallbacks(ckpt_dir, keep=f"fallback_{step}")

    init_state, start_step = None, 0
    found = _latest_fare_checkpoint(ckpt_dir) if args.resume else None
    if found is not None:
        start_step, path = found
        LOG.info("resuming FARE from %s (step %d)", path, start_step)
        init_state = ckpt.load_checkpoint(path)

    tracker = create_tracker(args.report_to, out_dir, args.experiment_name,
                             wandb_project=args.wandb_project_name,
                             config=vars(args)) if args.report_to else None
    on_step = None
    if tracker is not None:
        def on_step(step, metrics):
            tracker.log({f"train/{k}": v for k, v in metrics.items()},
                        step=step)

    out = fare.train_fare(visual, cfg, fcfg, repeat_forever(),
                          classifier=classifier, seed=args.seed,
                          on_step=on_step, checkpoint_fn=checkpoint_fn,
                          fallback_fn=fallback_fn, init_state=init_state,
                          start_step=start_step)
    # the last milestone must be on disk before the fallbacks go, or a
    # crash in between leaves neither
    ckpt.wait_for_checkpoints()
    if out["steps"] >= fcfg.steps:
        _remove_fallbacks(ckpt_dir)
    if tracker is not None:
        tracker.finish()
    LOG.info("FARE done: %d steps, final loss %.5g", out["steps"],
             out["final_loss"])
    return out


if __name__ == "__main__":
    main()
