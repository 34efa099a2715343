"""The LEAF training job: the port's fused LEAF step driven by its epoch loop
(`train.loop.train_one_epoch_text_only` with `fused_step`), on a pool of
seeded caption batches whose anchors set-up caches.

One loop call runs the whole run; its feed (`Feed`) hands it the checked
steps, which take a batch of every bucket the pool holds (`checked_order`)
and so warm each up, then the window's batches, cycling the pool, until
`seconds` have passed.  An
observer around the fused step (`Observer`) passes every call through and
keeps what the judge reads: the checked steps' draws and choices, the
optimizer's first moment after the first step and the parameters after the
last, and every step's loss.
"""
from __future__ import annotations

import copy
import gc
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import generate, weights
from portbench.jobs.common import Cell, Outcome, sync
from portbench.metrics.arith import Encode
from portbench.reference import leaf as ref
from portbench.reference.clip import strict_fp32
from portbench.reference.text import Constraint, tokenizer
from portbench.trace import Capture, Range

LABELS = ("leaf.step", "leaf.prepare_probes")


def checked_order(widths: List[int], n: int):
    """(checked, rest): pool indices of the checked steps, the first batch
    at each bucket in pool order and then the next unchosen batches until
    there are `n`, so that the comparison covers every bucket the pool
    holds; and the pool's other indices in order."""
    checked = [widths.index(w) for w in dict.fromkeys(widths)]
    for i in range(len(widths)):
        if len(checked) >= n:
            break
        if i not in checked:
            checked.append(i)
    checked.sort()
    return checked, [i for i in range(len(widths)) if i not in checked]


class Observer:
    """The fused step as the loop sees it, with its calls recorded."""

    def __init__(self, fused, checked: int, ranges: Range):
        self.fused = fused
        self.checked = checked
        self.ranges = ranges
        self.calls = 0
        self.records: List[dict] = []
        self.losses: List[torch.Tensor] = []
        self.profiled: List[dict] = []
        self.profiling = False
        self.first_moment = None
        self.params = None

    def prepare_probes(self, texts, rng):
        self.ranges.enter("leaf.prepare_probes")
        try:
            return self.fused.prepare_probes(texts, rng)
        finally:
            self.ranges.exit()

    def __call__(self, state, frozen_text, texts, rng, prepared=None):
        if prepared is None:
            # what the step does itself for a batch without prepared
            # probes, made here so that the drawn slots are seen
            prepared = self.prepare_probes(list(texts), rng)
        self.ranges.enter("leaf.step")
        try:
            state, info = self.fused(state, frozen_text, texts, rng,
                                     prepared=prepared)
        finally:
            self.ranges.exit()
        loss = info["metrics"]["loss"]
        self.losses.append(loss)
        keep = self.calls < self.checked or self.profiling
        if keep:
            best = info["best_char_idx"]
            rec = {"texts": list(texts),
                   "positions": np.asarray(prepared["positions"]),
                   "best_pos": np.asarray(info["best_pos"]),
                   "us": np.asarray(info["us"]),
                   "best": torch.cat(best) if isinstance(best, tuple)
                   else best, "loss": loss}
            (self.records if self.calls < self.checked
             else self.profiled).append(rec)
        if self.calls == 0:
            self.first_moment = {
                p: s["exp_avg"].clone()
                for p, s in state.optimizer.adamw.state.items()}
        if self.calls == self.checked - 1:
            self.params = {k: v.detach().clone()
                           for k, v in state.text.named_parameters()}
        self.calls += 1
        return state, info


class Feed:
    """The loop's batches: set-up steps, then the window's until its time
    is up; the window's ends are synchronised with the device."""

    def __init__(self, job: "Job", setup: List[List[str]],
                 window: List[List[str]]):
        self.job, self.setup, self.window = job, setup, window

    def __iter__(self):
        job = self.job
        for batch in self.setup:
            yield None, batch
        job.start_window()
        i = 0
        while not job.window_over():
            job.steps += 1
            yield None, self.window[i % len(self.window)]
            i += 1
        job.end_window()


class Job:
    """One run of a LEAF cell on one device."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.spec = cell.traffic
        self.capture = Capture() if cell.trace else None
        self.ranges = Range(self.capture)
        self.steps = 0
        self.outcome = Outcome()

    # -- the program -------------------------------------------------------

    def build(self):
        from leaf_tpu_torch.attacks import edits
        from leaf_tpu_torch.attacks.constraint import WordConstraint
        from leaf_tpu_torch.attacks.engine import (CandidateScorer,
                                                   bucket_tokens)
        from leaf_tpu_torch.models.clip import TextTower
        from leaf_tpu_torch.models.config import config_from_open_clip_dict
        from leaf_tpu_torch.models.factory import get_tokenizer
        from leaf_tpu_torch.train.fused import FusedLeafStep
        from leaf_tpu_torch.train.optim import make_optimizer
        from leaf_tpu_torch.train.schedules import cosine_lr
        from leaf_tpu_torch.train.step import (TrainState, make_anchor_encode,
                                               make_train_step)
        cell, spec, device = self.cell, self.spec, self.cell.device
        conf = cell.config
        self.cfg = config_from_open_clip_dict(conf["registry"], conf)
        specs = weights.text_specs(conf, conf["published_layers"])
        self.mark("imports")
        self.tensors = weights.make(specs, cell.seed, device)
        self.mark("weights")
        with torch.device(device):
            text = TextTower(self.cfg.text, self.cfg.quick_gelu)
        text.load_state_dict(weights.to_port(self.tensors))
        text.compute_dtype = getattr(torch, conf["compute_dtype"])
        frozen = copy.deepcopy(text).requires_grad_(False)
        self.mark("towers")
        self.tokenizer = get_tokenizer(conf["registry"])
        self.mark("tokenizer")
        schedule = cosine_lr(spec["lr"], spec["warmup"],
                             spec["schedule_steps"])
        optimizer = make_optimizer(
            text.named_parameters(), schedule, weight_decay=spec["wd"],
            beta1=spec["betas"][0], beta2=spec["betas"][1], eps=spec["eps"])
        self.state = TrainState(text=text, optimizer=optimizer,
                                step=spec["start_step"])
        self.frozen = frozen
        self.mark("optimizer")
        fused = FusedLeafStep(
            self.cfg, self.tokenizer, rho=spec["rho"],
            vocab=edits.DEFAULT_VOCAB, constraint=(
                WordConstraint() if spec["constrain"] else None),
            k=spec["k"], device=device)
        self.observer = Observer(fused, spec["checked_steps"], self.ranges)
        self.mark("fused step")
        self.pool = generate.caption_pool(spec, cell.seed)
        self.mark("captions")
        # the anchor cache of epochs after the first: every pool caption's
        # frozen features, from the program's anchor encode
        encode = make_anchor_encode()
        for batch in self.pool:
            tokens = bucket_tokens(self.tokenizer(batch))
            rows = encode(frozen, torch.from_numpy(np.ascontiguousarray(
                tokens)).to(device))
            fused.anchor_cache.update(zip(batch, rows))
        self.loop_args = dict(
            scorer=CandidateScorer(self.cfg, device),
            anchor_encode=encode, train_step=make_train_step(),
            vocab=edits.DEFAULT_VOCAB)
        self.mark("anchors")

    def mark(self, phase: str) -> None:
        self.outcome.phases[phase] = time.perf_counter() - self.cell.t_start

    def batches(self):
        """Set-up: the checked steps; the window: the pool's other batches,
        then the checked ones, cycled."""
        from leaf_tpu_torch.attacks.engine import bucket_tokens
        width = [bucket_tokens(self.tokenizer(b)).shape[-1] for b in self.pool]
        setup, rest = checked_order(width, self.spec["checked_steps"])
        self.observer.checked = len(setup)
        return ([self.pool[i] for i in setup],
                [self.pool[i] for i in rest + setup])

    def run(self) -> Outcome:
        from leaf_tpu_torch.data.common import DataInfo
        from leaf_tpu_torch.train.loop import train_one_epoch_text_only
        self.build()
        setup, window = self.batches()
        info = DataInfo(Feed(self, setup, window), num_batches=1 << 30,
                        num_samples=1 << 30)
        args = types.SimpleNamespace(
            accum_freq=1, log_every_n_steps=100, batch_size=self.spec["batch"],
            seed=self.cell.seed, use_charmer=False, profile_dir="",
            attack_objective="l2", rho=self.spec["rho"], k_adv=self.spec["k"])
        rng = generate.rng_for(self.cell.seed, "attack")
        try:
            self.state, _ = train_one_epoch_text_only(
                self.state, self.frozen, tokenizer=self.tokenizer,
                data={"train": info}, epoch=0, args=args, rng=rng,
                fused_step=self.observer, **self.loop_args)
        except Exception:
            if not hasattr(self, "t0"):
                raise
            if not self.outcome.window_s:
                self.outcome.window_s = time.perf_counter() - self.t0
                self.outcome.attempted = self.steps
            # a step of the window raised: the run is not correct
            self.outcome.failed += 1
            self.outcome.raised = True
        losses = self.observer.losses[len(setup):]
        if losses:
            finite = torch.isfinite(torch.stack(losses).float()).cpu()
            self.outcome.failed += int((~finite).sum())
        return self.outcome

    # -- the window ----------------------------------------------------------

    def start_window(self) -> None:
        sync(self.cell.device)
        self.t0 = time.perf_counter()
        self.outcome.setup_s = self.t0 - self.cell.t_start
        self.mark("steps")
        self.deadline = self.t0 + self.cell.seconds
        self.host0 = self.observer.fused.seconds["host"]
        if self.capture is not None:
            self.capture.start()
            self.observer.profiling = True

    def window_over(self) -> bool:
        done = time.perf_counter() >= self.deadline
        if self.capture is not None:
            done = done or self.steps >= self.spec["trace_steps"]
        return done

    def end_window(self) -> None:
        if self.capture is not None:
            self.capture.stop()
            self.observer.profiling = False
        sync(self.cell.device)
        o = self.outcome
        o.window_s = time.perf_counter() - self.t0
        o.attempted = self.steps
        o.units = self.steps * self.spec["batch"]
        o.counters = {"host_s": self.observer.fused.seconds["host"]
                      - self.host0}

    # -- after the window -----------------------------------------------------

    def trace(self):
        """The traced steps, reduced, with the encodes they required."""
        if self.capture is None:
            return None
        conf = self.cell.config["text_cfg"]
        constraint = (Constraint(tokenizer().whole_words())
                      if self.spec["constrain"] else None)
        work = []
        for rec in self.observer.profiled:
            best = rec["best"].cpu().numpy()
            probes, cands = ref.edited_rows(rec["texts"], rec["positions"],
                                            rec["best_pos"], rec["us"],
                                            constraint)
            adv = [[cands[i][int(best[i])]] for i in range(len(cands))]
            for rows, grad in ((probes, "none"), (cands, "none"),
                               (adv, "all")):
                work.append(Encode(
                    width=conf["width"], layers=conf["layers"],
                    heads=conf["heads"], mlp=4 * conf["width"],
                    embed=self.cell.config["embed_dim"],
                    lengths=ref.token_lengths(rows), causal=True, grad=grad))
        return self.capture.reduce("leaf", self.outcome.attempted, work,
                                   self.outcome.counters, LABELS)

    def program_outputs(self):
        """What the judge reads, in the reference's names, on the host or
        the device; the program's state is released."""
        obs, names = self.observer, {}
        port = dict(self.state.text.named_parameters())
        for oc_name in self.tensors:
            names[oc_name] = weights.port_names(oc_name)
        inv = {id(p): k for k, p in port.items()}
        b1 = self.spec["betas"][0]

        def oc(values_by_port, scale=1.0):
            out = {}
            for oc_name, (pname, transpose) in names.items():
                # a parameter the optimizer never updated has no moment
                v = values_by_port.get(pname, torch.zeros_like(port[pname]))
                v = v.float() * scale
                out[oc_name] = v.t() if transpose else v
            return out

        grad1 = oc({inv[id(p)]: m for p, m in obs.first_moment.items()},
                   1.0 / (1 - b1))
        params3 = oc(obs.params)
        steps = []
        for rec in obs.records:
            anchors = torch.stack([obs.fused.anchor_cache[t]
                                   for t in rec["texts"]]).float()
            steps.append(dict(rec, best=rec["best"].cpu().numpy(),
                              loss=float(rec["loss"]), anchors=anchors))
        self.checked_inputs = [{k: r[k] for k in ("texts", "positions", "us")}
                               for r in steps]
        self.release()
        return steps, grad1, params3

    def release(self) -> None:
        for name in ("state", "frozen", "observer", "loop_args"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        steps, grad1, params3 = self.program_outputs()
        conf = self.cell.config
        with strict_fp32():
            return ref.judge(self.tensors, steps, grad1, params3, self.spec,
                             conf["text_cfg"]["heads"],
                             conf.get("quick_gelu", False))

    def stand_in(self, fp8: bool, fault: Optional[str]) -> Dict[str, float]:
        """The control or a planted fault in the program's place, on the
        program's checked inputs, judged as the program is."""
        conf = self.cell.config
        heads = conf["text_cfg"]["heads"]
        with strict_fp32():
            alt = ref.StandIn(self.tensors, self.spec, heads,
                              conf.get("quick_gelu", False), fp8, fault)
            out = alt.run(self.checked_inputs)
            del alt
            return ref.judge(self.tensors, *out, self.spec, heads,
                             conf.get("quick_gelu", False))
