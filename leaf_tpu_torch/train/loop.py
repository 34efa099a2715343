"""LEAF training epoch loop (port of `leaf_tpu/train/loop.py`).

Per batch, on the unfused branch:

  1. frozen-tower anchor encode of the clean captions (device),
  2. inner max: LEAF batch attack (or the batched Charmer with
     `--use_charmer`) against the *trainable* tower, anchored to the
     frozen features,
  3. one train step: TextFARE MSE + AdamW update,
  4. meters, attack-timing ledger.

With `fused_step` (a `train.fused.FusedLeafStep`: every recipe but
`--use_charmer`), a batch is one call of the fused step, which selects
the winners on the device and never builds the adversarial strings;
while its train update runs on the device, the loop pulls batch i+1 and
prepares its probes on the host.  Nothing between enqueuing a step and
that preparation reads a device value: a logged step's loss stays a
tensor until the next logging point.

Across ranks each rank runs its own rows of the global batch: the unfused
step's token buffers take the bucket width agreed across ranks
(`engine.bucket_tokens_coordinated`), and samples/s counts the global
batch.

The attack wall-time CSV (`times_{use_charmer}.csv`) is the trainer's
own throughput record and is kept; on the fused branch a worker thread
writes it (`utils.results.AsyncAttackTimer`).
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from leaf_tpu_torch.attacks.engine import (CandidateScorer, bucket_tokens,
                                           bucket_tokens_coordinated,
                                           can_bucket)
from leaf_tpu_torch.attacks.text import (attack_text_charmer_batched,
                                         attack_text_leaf)
from leaf_tpu_torch.models.clip import TextTower
from leaf_tpu_torch.parallel.distributed import world_size
from leaf_tpu_torch.train.step import TrainState
from leaf_tpu_torch.utils.meters import AverageMeter
from leaf_tpu_torch.utils.results import AsyncAttackTimer, TimingLedger
from leaf_tpu_torch.utils.tracing import TraceWindow, span

LOG = logging.getLogger(__name__)


def run_attack(scorer: CandidateScorer, text: TextTower, tokenizer, texts,
               anchors, args, vocab, constraint, rng,
               seconds: Optional[dict] = None):
    """Training-time inner maximisation: the LEAF attack, or with
    `--use_charmer` the batched Charmer (each sentence's search that of
    the per-sentence attack; deterministic, it draws nothing from
    `rng`)."""
    objective = getattr(args, "attack_objective", "l2")
    if args.use_charmer:
        return attack_text_charmer_batched(
            scorer, text, tokenizer, list(texts), anchors,
            objective=objective, n=args.rho, k=args.k_adv, vocab=vocab,
            constraint=constraint, seconds=seconds)
    _, adv_texts = attack_text_leaf(
        scorer, text, tokenizer, list(texts), anchors,
        objective=objective, n=args.rho, k=args.k_adv, vocab=vocab,
        constraint=constraint, rng=rng, seconds=seconds)
    return adv_texts


def train_one_epoch_text_only(
    state: TrainState,
    frozen_text: TextTower,
    scorer: CandidateScorer,
    anchor_encode,
    train_step,
    tokenizer,
    vocab,
    data: Dict,
    epoch: int,
    args,
    constraint=None,
    timing: Optional[TimingLedger] = None,
    rng: Optional[np.random.Generator] = None,
    seconds: Optional[dict] = None,
    fused_step=None,
    tracker=None,
):
    """Run one epoch; returns (state, log_data).

    With `fused_step`, each batch runs as the fused step; selection and
    update semantics are those of the unfused branch
    (tests/test_torch_fused.py).  Under `--accum-freq k` an optimizer
    update is applied every k batches, and steps, log lines and
    `num_batches_per_epoch` count updates.

    `seconds`, if given, collects the unfused attack's wall seconds on
    the host (edits and tokenizing) and in device scoring calls, summed
    over the epoch (see `attack_text_leaf` and
    `attack_text_charmer_batched`); the fused step keeps its own
    (`FusedLeafStep.seconds`).  Each logged step's `log_data` also goes
    to `tracker`, and with `args.profile_dir` batches 2 to 5 of epoch 0
    are traced (`utils.tracing.TraceWindow`).  Each pull from the loader
    is the span `train.loop.next_batch` (`utils.tracing`)."""
    rng = rng or np.random.default_rng(args.seed + 1000 * epoch)
    world = world_size()
    # across ranks the width is agreed per buffer (one small all-reduce)
    _bucket = np.asarray
    if can_bucket(scorer.cfg):
        _bucket = bucket_tokens if world == 1 else bucket_tokens_coordinated
    device = scorer.device
    info = data["train"]
    info.set_epoch(epoch)
    num_batches_per_epoch = info.num_batches // args.accum_freq

    losses_m = AverageMeter()
    batch_time_m = AverageMeter()
    data_time_m = AverageMeter()
    end = time.time()

    log_data: Dict[str, float] = {}
    # deferred logging: a logged step's loss stays a device tensor until
    # the next logging point (or the epoch's end), so that reading it
    # does not make the host wait for the step it has just dispatched.
    # Content and order of the emitted lines are the JAX package's.
    pending_log: Optional[Dict] = None

    def _flush(rec: Optional[Dict]):
        nonlocal log_data
        if rec is None:
            return
        loss_val = float(rec["loss_arr"])
        losses_m.update(loss_val, rec["n_texts"])
        LOG.info(
            "Train Epoch: %d [%d/%d (%.0f%%)] "
            "Data (t): %.3f Batch (t): %.3f, %.1f/s "
            "Attack (t): %.3f Loss: %.5g (%.5g)",
            epoch, rec["seen"], info.num_samples, rec["pct"],
            rec["data_time"], rec["batch_time"], rec["sps"],
            rec["attack_seconds"], loss_val, losses_m.avg)
        log_data = {
            "train/loss": loss_val,
            "train/data_time": rec["data_time_val"],
            "train/batch_time": rec["batch_time_val"],
            "train/samples_per_second": rec["sps"],
            "train/attack_seconds": rec["attack_seconds"],
            "train/step": rec["step"],
        }
        if tracker is not None:
            tracker.log(log_data, step=rec["step"])

    def put(tokens) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(tokens)).to(device)

    def next_batch(it):
        with span("train.loop.next_batch"):
            return next(it, None)

    attack_timer = None
    if fused_step is not None and timing is not None:
        attack_timer = AsyncAttackTimer(timing)
    loader_it = iter(info.loader)
    batch = next_batch(loader_it)
    prepared = None
    trace = TraceWindow(getattr(args, "profile_dir", None), epoch)
    i = -1
    while batch is not None:
        i += 1
        trace.step(i)
        images, texts = batch
        del images  # the text-only objective ignores images
        i_accum = i // args.accum_freq
        step = num_batches_per_epoch * epoch + i_accum
        data_time_m.update(time.time() - end)

        if fused_step is not None:
            t0 = time.perf_counter()
            state, step_info = fused_step(state, frozen_text, list(texts),
                                          rng, prepared=prepared)
            metrics = step_info["metrics"]
            # attack-only timing: the worker thread waits on the step's
            # attack marker (an event behind the last scoring call) and
            # records t_ready - t0, the train update excluded, without a
            # sync on this thread that would break the overlap below.  t0
            # is at step entry, so a step whose anchors miss the cache
            # also counts the anchor encode.
            if attack_timer is not None:
                attack_timer.submit(t0, step_info["attack_marker"])
                attack_seconds = attack_timer.last  # lags by <= 1 step
            else:
                attack_seconds = time.perf_counter() - t0
            # overlap: while this batch's train update runs on the device,
            # pull batch i+1 and do its host-side probe prep (edit
            # tokenisation + constraint masks).  The rng draw order is that
            # of the unoverlapped loop: positions for i+1 were always drawn
            # after batch i's characters.
            batch = next_batch(loader_it)
            prepared = None
            if batch is not None:
                prepared = fused_step.prepare_probes(list(batch[1]), rng)
        else:
            tokens = put(_bucket(tokenizer(texts)))
            anchors = anchor_encode(frozen_text, tokens)

            t0 = time.time()
            adv_texts = run_attack(scorer, state.text, tokenizer, texts,
                                   anchors, args, vocab, constraint, rng,
                                   seconds)
            attack_seconds = time.time() - t0
            if timing is not None:
                timing.append(attack_seconds)

            adv_tokens = put(_bucket(tokenizer(adv_texts)))
            state, metrics = train_step(state, adv_tokens, anchors)
            batch = next_batch(loader_it)

        batch_time_m.update(time.time() - end)
        end = time.time()
        batch_count = i_accum + 1

        if ((i + 1) % args.accum_freq == 0
                and (batch_count % args.log_every_n_steps == 0
                     or batch_count == num_batches_per_epoch)):
            rec = {
                "loss_arr": metrics["loss"],
                "n_texts": len(texts),
                "seen": batch_count * args.batch_size * args.accum_freq,
                "pct": 100.0 * batch_count / max(num_batches_per_epoch, 1),
                "data_time": data_time_m.avg,
                "batch_time": batch_time_m.avg,
                "data_time_val": data_time_m.val,
                "batch_time_val": batch_time_m.val,
                "sps": (args.accum_freq * args.batch_size * world
                        / batch_time_m.val),
                "attack_seconds": attack_seconds,
                "step": step,
            }
            _flush(pending_log)
            pending_log = rec
            batch_time_m.reset()
            data_time_m.reset()

    trace.close()
    _flush(pending_log)
    if attack_timer is not None:
        attack_timer.close()  # every step's row written, in step order
    log_data.setdefault("train/loss", losses_m.avg if losses_m.count else 0.0)
    return state, log_data
