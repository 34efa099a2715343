"""FARE adversarial fine-tuning of the vision tower (port of
`leaf_tpu/train/fare.py`).

Unsupervised embedding adversarial training: the inner maximisation (PGD
with a uniform start, or APGD) pushes the trainable tower's embedding of
the images away from the frozen tower's; the outer minimisation pulls the
embedding of the adversarial images back, ||f(x_adv) - f_frozen(x)||^2 by
default (L1, the cross-entropy against a zero-shot classifier, a clean
term and TRADES are the other options).

Precision is the JAX package's: the trainable tower keeps fp32 master
weights and every encode of the step computes in the tower's
`compute_dtype` (bf16 for `--precision bf16`), LayerNorm, softmax and the
losses in fp32.  The frozen tower is a deep copy of the trainable one,
made before training and never updated.  On a card every encode runs the
hand kernels (`ops.packed_attention`); the differentiated encodes of the
attack and the update recompute each block in the backward pass when
`remat` is set (`torch.utils.checkpoint`), so that such an encode
launches each block's kernels twice.  The attack asks for the images'
gradient alone: the tower's weights stop requiring gradients for it.

Against the JAX step: where it encodes the clean images although
`clean_weight == 0` and not `trades` (XLA drops that encode), this one
does not encode them; the uniform start of PGD comes from a
`torch.Generator` seeded by `seed` (or from `starts`, one perturbation a
step), since `jax.random.uniform`'s draws cannot be reproduced.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from leaf_tpu_torch.attacks.apgd import apgd
from leaf_tpu_torch.attacks.image import _normalize_images, pgd
from leaf_tpu_torch.data.common import put_batch
from leaf_tpu_torch.models.clip import VisionTower, l2_normalize
from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.train.optim import Optimizer
from leaf_tpu_torch.train.schedules import cosine_lr
from leaf_tpu_torch.utils.meters import AverageMeter

LOG = logging.getLogger(__name__)


def encode_vision(visual: VisionTower, cfg: CLIPConfig, images: torch.Tensor,
                  output_normalize: bool, remat: bool = False) -> torch.Tensor:
    """Images in [0, 1] -> embedding (the normalisation folded in), in the
    tower's compute dtype."""
    return visual.encode_image(_normalize_images(images, cfg),
                               output_normalize, remat=remat)


def embedding_loss(loss_str: str, embedding, embedding_orig, targets=None,
                   classifier=None, logit_scale: float = 100.0,
                   reduction: str = "mean") -> torch.Tensor:
    """FARE's losses: l2, l1, ce (against the [D, K] `classifier`) and
    ce_reg (0.7 ce + 0.3 l2), in fp32."""
    emb32 = embedding.float()
    if loss_str == "l2":
        per = (emb32 - embedding_orig.float()).square().sum(-1)
    elif loss_str == "l1":
        per = (emb32 - embedding_orig.float()).abs().sum(-1)
    elif loss_str == "ce":
        if classifier is None:
            raise ValueError("the ce losses need a zero-shot classifier")
        logits = emb32 @ (logit_scale * classifier.float())
        logp = torch.log_softmax(logits, dim=-1)
        per = -logp.gather(1, targets.long()[:, None])[:, 0]
    elif loss_str == "ce_reg":
        return (0.7 * embedding_loss("ce", embedding, embedding_orig,
                                     targets, classifier, logit_scale,
                                     reduction)
                + 0.3 * embedding_loss("l2", embedding, embedding_orig,
                                       reduction=reduction))
    else:
        raise ValueError(f"loss {loss_str!r} not supported")
    return per.mean() if reduction == "mean" else per


@dataclasses.dataclass
class FareConfig:
    """The trainer's flags (the reference's `adversarial_training_clip.py`
    parser); `eps` and `stepsize_adv` in pixel units, already divided by
    255."""
    steps: int = 10000
    warmup: int = 700
    batch_size: int = 128
    lr: float = 1e-5
    wd: float = 1e-4
    opt: str = "adamw"
    momentum_sgd: float = 0.9
    attack: str = "pgd"            # pgd | apgd | none
    norm: str = "linf"
    eps: float = 2 / 255
    iterations_adv: int = 10
    stepsize_adv: float = 1 / 255
    inner_loss: str = "l2"
    loss: str = "l2"
    loss_clean: str = "l2"
    clean_weight: float = 0.0
    trades: bool = False
    output_normalize: bool = False
    grad_clip: bool = False
    log_freq: int = 10
    # the rolling crash-recovery checkpoint's cadence in steps; 0: none
    fallback_freq: int = 20
    # parsed and unread, as in the JAX package
    eval_freq: int = 50
    # recompute each block in the differentiated encodes' backward
    remat: bool = True


class _TraceSGD(torch.optim.Optimizer):
    """optax's `trace(momentum) -> add_decayed_weights(wd) -> -lr`: the
    momentum buffer sums raw gradients and the decay is added after it
    (torch's SGD adds the decay to the gradient before the momentum)."""

    def __init__(self, params, lr: float, momentum: float,
                 weight_decay: float):
        super().__init__(params, {"lr": lr, "momentum": momentum,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "trace" not in state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"].mul_(group["momentum"]).add_(p.grad)
                p.sub_(group["lr"] * (trace + group["weight_decay"] * p))


def make_fare_optimizer(params: Iterable[torch.nn.Parameter],
                        fcfg: FareConfig) -> Optimizer:
    """Adam with decoupled weight decay on every parameter (optax's
    `scale_by_adam` defaults: betas 0.9 / 0.999, eps 1e-8), or SGD with
    momentum (`--opt sgd`, in the `adamw` slot of `Optimizer`); the cosine
    schedule after `warmup` steps; with `grad_clip` the gradients first
    clipped to a global norm of 1."""
    schedule = cosine_lr(fcfg.lr, fcfg.warmup, fcfg.steps)
    params = list(params)
    if fcfg.opt == "sgd":
        inner = _TraceSGD(params, schedule(0), fcfg.momentum_sgd, fcfg.wd)
    else:
        inner = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=fcfg.wd)
    return Optimizer(inner, schedule, 1.0 if fcfg.grad_clip else None)


@contextlib.contextmanager
def _weights_frozen(module: torch.nn.Module):
    """The module's parameters require no gradient inside (the kernels'
    backward then computes the input's gradient alone)."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def make_fare_attack(visual: VisionTower, cfg: CLIPConfig, fcfg: FareConfig):
    """The inner maximisation on the trainable tower: `attack(images,
    embedding_orig, targets, classifier, generator=None, delta=None) ->
    adversarial images`.  PGD starts from `delta` where it is given, else
    from a uniform draw of `generator`."""

    def attack(images, embedding_orig, targets, classifier,
               generator: Optional[torch.Generator] = None,
               delta: Optional[torch.Tensor] = None) -> torch.Tensor:
        if fcfg.attack == "none":
            return images
        reduction = "mean" if fcfg.attack == "pgd" else "none"

        def loss_fn(x_adv):
            emb = encode_vision(visual, cfg, x_adv, fcfg.output_normalize,
                                remat=fcfg.remat)
            return embedding_loss(fcfg.inner_loss, emb, embedding_orig,
                                  targets, classifier, reduction=reduction)

        with _weights_frozen(visual):
            if fcfg.attack == "apgd":
                # is_train: L1 starts at the sparser top-k share
                return apgd(loss_fn, images, norm=fcfg.norm, eps=fcfg.eps,
                            n_iter=fcfg.iterations_adv, is_train=True)
            if delta is None:
                # the start goes to the first forward unclamped, as in the
                # reference; the image box is enforced after each step
                u = torch.rand(images.shape, generator=generator,
                               dtype=images.dtype, device=images.device)
                delta = fcfg.eps * (2 * u - 1)
            return pgd(loss_fn, images, norm=fcfg.norm, eps=fcfg.eps,
                       iterations=fcfg.iterations_adv,
                       stepsize=fcfg.stepsize_adv, mode="max",
                       perturbation=delta)

    return attack


def make_fare_train_step(visual: VisionTower, cfg: CLIPConfig,
                         fcfg: FareConfig, opt: Optimizer):
    """The outer update: `step_fn(step, embedding_orig, images, adv_images,
    targets, classifier) -> metrics` (device tensors: loss, loss_clean,
    cos_sim), one optimizer update at `step` (the count of earlier
    updates)."""

    def step_fn(step: int, embedding_orig, images, adv_images, targets,
                classifier) -> Dict[str, torch.Tensor]:
        with torch.enable_grad():
            loss_clean = torch.zeros((), device=images.device)
            emb_clean = None
            if fcfg.clean_weight > 0 or fcfg.trades:
                with torch.set_grad_enabled(fcfg.clean_weight > 0):
                    emb_clean = encode_vision(visual, cfg, images,
                                              fcfg.output_normalize,
                                              remat=fcfg.remat)
                if fcfg.clean_weight > 0:
                    loss_clean = embedding_loss(fcfg.loss_clean, emb_clean,
                                                embedding_orig, targets,
                                                classifier)
            emb_adv = encode_vision(visual, cfg, adv_images,
                                    fcfg.output_normalize, remat=fcfg.remat)
            anchor = emb_clean.detach() if fcfg.trades else embedding_orig
            loss_adv = embedding_loss(fcfg.loss, emb_adv, anchor, targets,
                                      classifier)
            total = (fcfg.clean_weight * loss_clean
                     + (1 - fcfg.clean_weight) * loss_adv)
            total.backward()
        with torch.no_grad():
            cos = (l2_normalize(emb_adv.float())
                   * l2_normalize(embedding_orig.float())).sum(-1).mean()
        opt.update(step)
        return {"loss": loss_adv.detach(), "loss_clean": loss_clean.detach(),
                "cos_sim": cos}

    return step_fn


@dataclasses.dataclass
class FareState:
    """What a checkpoint holds: the trained tower, the optimizer and the
    count of updates."""
    visual: VisionTower
    optimizer: Optimizer
    step: int

    def payload(self) -> Dict:
        return {"visual_params": self.visual.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}


class _Marks:
    """Named points of one step: CUDA events on a card (read when the
    step's metrics are read), host clock readings on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points: List = []

    def __call__(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.points.append((name, event))
        else:
            self.points.append((name, time.perf_counter()))

    def seconds(self) -> Dict[str, float]:
        """Seconds from each point to the next, under the later's name,
        and from the first to the last as "step"."""
        def span(a, b):
            if self.cuda:
                return a.elapsed_time(b) / 1e3
            return b - a
        out = {f"{name}_s": span(prev, cur) for (_, prev), (name, cur)
               in zip(self.points, self.points[1:])}
        out["step_s"] = span(self.points[0][1], self.points[-1][1])
        return out


class _Pending:
    """One step's metrics on their way to the host: copied behind the
    step's work and read after the next step has been enqueued, so that
    the host never waits for the step it has just enqueued."""

    def __init__(self, metrics: Dict[str, torch.Tensor], marks: _Marks,
                 n: int, step: int, wait_s: float):
        self.keys = list(metrics)
        stacked = torch.stack([metrics[k].float() for k in self.keys])
        self.values = stacked.to("cpu", non_blocking=stacked.is_cuda)
        self.done = None
        if stacked.is_cuda:
            self.done = torch.cuda.Event()
            self.done.record()
        self.marks, self.n, self.step, self.wait_s = marks, n, step, wait_s

    def read(self):
        if self.done is not None:
            self.done.synchronize()
        values = dict(zip(self.keys, self.values.tolist()))
        return values, dict(self.marks.seconds(), wait_s=self.wait_s)


def _start_generator(device: torch.device, seed: int,
                     start_step: int) -> torch.Generator:
    """PGD starts from `seed`; a resumed run takes another stream (the JAX
    package folds the start step into its key)."""
    if start_step:
        seed = int(np.random.SeedSequence([seed, start_step])
                   .generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def train_fare(visual: VisionTower, cfg: CLIPConfig, fcfg: FareConfig,
               data_iter: Iterable, classifier: Optional[torch.Tensor] = None,
               seed: int = 0,
               on_step: Optional[Callable[[int, Dict], None]] = None,
               checkpoint_fn: Optional[Callable[[int, FareState], None]] = None,
               fallback_fn: Optional[Callable[[int, FareState], None]] = None,
               init_state: Optional[Dict] = None, start_step: int = 0,
               starts: Optional[Iterator[torch.Tensor]] = None) -> Dict:
    """Train `visual` (in place) for `fcfg.steps` optimizer steps.

    `data_iter` yields (images [B, H, W, 3] in [0, 1], targets or None)
    host batches.  Checkpoints: `checkpoint_fn` at 10 evenly spaced
    milestones (the last is the final step), `fallback_fn` every
    `fcfg.fallback_freq` steps.  `init_state` (a checkpoint's payload) and
    `start_step` resume: the parameters, the optimizer's moments and the
    step; the data stream restarts.  `starts`, if given, yields PGD's
    initial perturbation for each step in place of the generator's.

    Each step's metrics are read one step late (the log lines and
    `on_step` come one step behind).  Returns {"visual", "frozen", "state",
    "steps", "final_loss", "times"}: "frozen" is the anchor tower, "times"
    holds, per step, the seconds the loader kept the host waiting
    ("wait_s") and the device's seconds for the anchors, the attack and the
    update and for the whole step."""
    device = next(visual.parameters()).device
    # the anchors come from the weights the run started from, also when
    # it resumes
    frozen = copy.deepcopy(visual).requires_grad_(False)
    opt = make_fare_optimizer(visual.parameters(), fcfg)
    if init_state is not None:
        visual.load_state_dict(init_state["visual_params"])
        if init_state.get("opt_state") is not None:
            opt.load_state_dict(init_state["opt_state"])
    state = FareState(visual, opt, start_step)
    attack = make_fare_attack(visual, cfg, fcfg)
    train_step = make_fare_train_step(visual, cfg, fcfg, opt)
    generator = _start_generator(device, seed, start_step)

    milestones = {int(fcfg.steps * (i + 1) / 10) for i in range(10)}
    loss_m = AverageMeter()
    times: List[Dict[str, float]] = []
    t0 = time.time()

    def flush(pending: Optional[_Pending]) -> None:
        if pending is None:
            return
        m, seconds = pending.read()
        times.append(seconds)
        loss_m.update(m["loss"], pending.n)
        if on_step is not None:
            on_step(pending.step, m)
        if pending.step % fcfg.log_freq == 0:
            LOG.info("FARE step %d/%d loss %.5g (%.5g) cos %.4f [%.2fs/step]",
                     pending.step, fcfg.steps, loss_m.val, loss_m.avg,
                     m["cos_sim"],
                     (time.time() - t0) / max(pending.step - start_step, 1))

    pending = None
    batches = iter(data_iter)
    while state.step < fcfg.steps:
        t_wait = time.perf_counter()
        try:
            images, targets = next(batches)
        except StopIteration:
            break
        wait_s = time.perf_counter() - t_wait
        n = len(images)
        marks = _Marks(device)
        images = put_batch(images, device, torch.float32)
        targets = put_batch(targets if targets is not None
                            else np.zeros((n,), np.int64), device, torch.long)
        marks("start")
        with torch.no_grad():
            embedding_orig = encode_vision(frozen, cfg, images,
                                           fcfg.output_normalize)
        marks("anchor")
        adv = attack(images, embedding_orig, targets, classifier, generator,
                     None if starts is None else next(starts))
        marks("attack")
        metrics = train_step(state.step, embedding_orig, images, adv, targets,
                             classifier)
        marks("update")
        state.step += 1
        flush(pending)
        pending = _Pending(metrics, marks, n, state.step, wait_s)
        if checkpoint_fn is not None and state.step in milestones:
            checkpoint_fn(state.step, state)
        if fallback_fn is not None and fcfg.fallback_freq \
                and state.step % fcfg.fallback_freq == 0:
            fallback_fn(state.step, state)
    flush(pending)
    return {"visual": visual, "frozen": frozen, "state": state,
            "steps": state.step, "final_loss": loss_m.avg, "times": times}
