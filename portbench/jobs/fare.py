"""The FARE training job: the port's FARE trainer (`train.fare.train_fare`)
on a pool of seeded host batches of images, PGD's starts drawn on the
device from the seed.

One `train_fare` call runs the whole run; its feed hands it the checked
steps, then the window's batches, cycling the pool, until `seconds` have
passed.  The trainer builds its attack and its update step through
`make_fare_attack` and `make_fare_train_step`; for the call, the job hands
it versions that pass every call through and keep what the judge reads:
the checked steps' images, starts, adversarial images, anchors and
losses, the optimizer's first moment after the first step and the
parameters after the last, and every step's loss.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional

import torch

from portbench import generate, weights
from portbench.jobs.common import Cell, Outcome, sync
from portbench.metrics.arith import Encode
from portbench.reference import fare as ref
from portbench.reference.clip import strict_fp32
from portbench.trace import Capture, Range

LABELS = ("fare.anchors", "fare.attack", "fare.update")


class Job:
    """One run of a FARE cell on one device."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.spec = cell.traffic
        self.capture = Capture() if cell.trace else None
        self.ranges = Range(self.capture)
        self.steps = 0
        self.calls = 0
        self.outcome = Outcome()
        self.records: List[dict] = []
        self.losses: List[torch.Tensor] = []
        self.pending: Dict = {}

    def build(self):
        from leaf_tpu_torch.models.clip import VisionTower
        from leaf_tpu_torch.models.config import config_from_open_clip_dict
        from leaf_tpu_torch.train import fare
        cell, spec, conf = self.cell, self.spec, self.cell.config
        self.cfg = config_from_open_clip_dict(conf["registry"], conf)
        specs = weights.vision_specs(conf, conf["published_layers"])
        self.mark("imports")
        self.tensors = weights.make(specs, cell.seed, cell.device)
        self.mark("weights")
        with torch.device(cell.device):
            visual = VisionTower(self.cfg.vision, self.cfg.quick_gelu)
        visual.load_state_dict(weights.to_port(self.tensors))
        visual.compute_dtype = getattr(torch, conf["compute_dtype"])
        self.visual = visual
        self.fcfg = fare.FareConfig(
            steps=spec["steps"], warmup=spec["warmup"],
            batch_size=spec["batch"], lr=spec["lr"], wd=spec["wd"],
            opt="adamw", attack="pgd", norm="linf", eps=spec["eps"],
            iterations_adv=spec["iterations"], stepsize_adv=spec["step"],
            inner_loss=spec["loss"], loss=spec["loss"], remat=spec["remat"],
            fallback_freq=0)
        self.mark("model")
        self.pool = generate.image_pool(spec, cell.seed)
        self.mark("images")

    def mark(self, phase: str) -> None:
        self.outcome.phases[phase] = time.perf_counter() - self.cell.t_start

    def starts(self):
        """PGD's start for each step: uniform in the eps-ball, drawn on
        the device."""
        spec = self.spec
        gen = torch.Generator(device=self.cell.device).manual_seed(
            int(generate.rng_for(self.cell.seed, "starts").integers(1 << 62)))
        shape = (spec["batch"], spec["image_size"], spec["image_size"], 3)
        while True:
            u = torch.rand(shape, generator=gen, device=self.cell.device)
            yield spec["eps"] * (2 * u - 1)

    def feed(self):
        n = self.spec["checked_steps"]
        for images in self.pool[:n]:
            yield images, None
        self.start_window()
        window = self.pool[n:] + self.pool[:n]
        i = 0
        while not self.window_over():
            self.steps += 1
            self.ranges.enter("fare.anchors")
            yield window[i % len(window)], None
            i += 1
        self.end_window()

    @contextlib.contextmanager
    def observed(self):
        """`train_fare`'s attack and update, passed through and recorded."""
        from leaf_tpu_torch.train import fare
        make_attack = fare.make_fare_attack
        make_step = fare.make_fare_train_step
        job = self

        def attack_maker(visual, cfg, fcfg):
            attack = make_attack(visual, cfg, fcfg)

            def run(images, embedding_orig, targets, classifier,
                    generator=None, delta=None):
                job.ranges.exit()
                job.ranges.enter("fare.attack")
                try:
                    adv = attack(images, embedding_orig, targets, classifier,
                                 generator, delta)
                finally:
                    job.ranges.exit()
                if job.calls < job.spec["checked_steps"]:
                    job.pending = {"images": images, "start": delta,
                                   "adv": adv, "anchors": embedding_orig}
                return adv
            return run

        def step_maker(visual, cfg, fcfg, opt):
            step_fn = make_step(visual, cfg, fcfg, opt)

            def run(step, embedding_orig, images, adv_images, targets,
                    classifier):
                job.ranges.enter("fare.update")
                try:
                    metrics = step_fn(step, embedding_orig, images,
                                      adv_images, targets, classifier)
                finally:
                    job.ranges.exit()
                job.after_update(opt, visual, metrics["loss"])
                return metrics
            return run

        fare.make_fare_attack, fare.make_fare_train_step = (attack_maker,
                                                            step_maker)
        try:
            yield
        finally:
            fare.make_fare_attack, fare.make_fare_train_step = (make_attack,
                                                                make_step)

    def after_update(self, opt, visual, loss) -> None:
        self.losses.append(loss)
        if self.calls < self.spec["checked_steps"]:
            self.records.append(dict(self.pending, loss=loss))
        if self.calls == 0:
            self.first_moment = {p: s["exp_avg"].clone()
                                 for p, s in opt.adamw.state.items()}
            self.named = {id(p): k for k, p in visual.named_parameters()}
        if self.calls == self.spec["checked_steps"] - 1:
            self.params = {k: v.detach().clone()
                           for k, v in visual.named_parameters()}
        self.calls += 1

    def run(self) -> Outcome:
        from leaf_tpu_torch.train import fare
        self.build()
        try:
            with self.observed():
                fare.train_fare(self.visual, self.cfg, self.fcfg, self.feed(),
                                seed=self.cell.seed,
                                start_step=self.spec["start_step"],
                                starts=self.starts())
        except Exception:
            if not hasattr(self, "t0"):
                raise
            if not self.outcome.window_s:
                self.outcome.window_s = time.perf_counter() - self.t0
                self.outcome.attempted = self.steps
            self.outcome.failed += 1
            self.outcome.raised = True
        losses = self.losses[self.spec["checked_steps"]:]
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
        if self.capture is not None:
            self.capture.start()

    def window_over(self) -> bool:
        done = time.perf_counter() >= self.deadline
        if self.capture is not None:
            done = done or self.steps >= self.spec["trace_steps"]
        return done

    def end_window(self) -> None:
        if self.capture is not None:
            self.capture.stop()
        sync(self.cell.device)
        o = self.outcome
        o.window_s = time.perf_counter() - self.t0
        o.attempted = self.steps
        o.units = self.steps * self.spec["batch"]

    # -- after the window -----------------------------------------------------

    def trace(self):
        if self.capture is None:
            return None
        v, spec = self.cell.config["vision_cfg"], self.spec
        tokens = (v["image_size"] // v["patch_size"]) ** 2 + 1
        width = v["width"]

        def encode(grad):
            return Encode(width=width, layers=v["layers"],
                          heads=width // v["head_width"], mlp=4 * width,
                          embed=self.cell.config["embed_dim"],
                          lengths=torch.full((spec["batch"],), tokens).numpy(),
                          causal=False, grad=grad,
                          patch_dim=3 * v["patch_size"] ** 2)

        per_step = ([encode("none")]
                    + [encode("input")] * spec["iterations"]
                    + [encode("all")])
        return self.capture.reduce("fare", self.outcome.attempted,
                                   per_step * self.outcome.attempted, {},
                                   LABELS)

    def program_outputs(self):
        names = {oc: weights.port_names(oc) for oc in self.tensors}
        b1 = self.spec["betas"][0]
        moment = {self.named[id(p)]: m for p, m in self.first_moment.items()}

        def oc(by_port, scale=1.0):
            out = {}
            for oc_name, (pname, transpose) in names.items():
                # a parameter the optimizer never updated has no moment
                val = by_port.get(pname, torch.zeros_like(self.params[pname]))
                val = val.float() * scale
                if oc_name == "visual.conv1.weight":
                    p = self.cell.config["vision_cfg"]["patch_size"]
                    val = val.reshape(p, p, 3, -1).permute(3, 2, 0, 1)
                out[oc_name] = val.t() if transpose else val
            return out

        grad1 = oc(moment, 1.0 / (1 - b1))
        params3 = oc(self.params)
        steps = [dict(r, loss=float(r["loss"])) for r in self.records]
        self.checked_inputs = [{"images": r["images"], "start": r["start"]}
                               for r in steps]
        for name in ("visual", "first_moment", "params", "losses"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        torch.cuda.empty_cache()
        return steps, grad1, params3

    def check(self) -> Dict[str, float]:
        steps, grad1, params3 = self.program_outputs()
        return self._judge(steps, grad1, params3)

    def _judge(self, steps, grad1, params3):
        conf = self.cell.config
        v = conf["vision_cfg"]
        with strict_fp32():
            return ref.judge(self.tensors, steps, grad1, params3, self.spec,
                             v["width"] // v["head_width"],
                             conf.get("quick_gelu", False))

    def stand_in(self, fp8: bool, fault: Optional[str]) -> Dict[str, float]:
        conf = self.cell.config
        v = conf["vision_cfg"]
        with strict_fp32():
            alt = ref.StandIn(self.tensors, self.spec,
                              v["width"] // v["head_width"],
                              conf.get("quick_gelu", False), fp8, fault)
            out = alt.run(self.checked_inputs)
            del alt
        return self._judge(*out)
