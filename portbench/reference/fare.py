"""The FARE cell's judge: the reference follows the program's first steps
and holds what the program produced against it.

The program hands over, for each checked step, the clean images, PGD's
start, its adversarial images, its anchors and its loss; after the first
step its optimizer's first moment (the gradient, as AdamW got it) and
after the last its parameters.  The reference encodes the anchors with the
frozen tower, checks that the adversarial images lie in the eps-ball and
the [0, 1] box, runs its own PGD from the same start to judge the
attack's strength, evaluates the loss at the program's adversarial images
and follows them into its own AdamW update, all in float32, in blocks of
`CHUNK` images.  `StandIn` puts the reference in the program's place: in
fp8 (the control) or with a planted fault.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import clip
from portbench.reference.leaf import compare_updates

CHUNK = 32


class Model:
    def __init__(self, tensors: Dict[str, torch.Tensor], heads: int,
                 quick_gelu: bool, fp8: bool = False):
        self.train = {k: v.clone().requires_grad_(True)
                      for k, v in tensors.items()}
        self.frozen = clip.VisionTower({k: v.clone() for k, v in
                                        tensors.items()}, heads, quick_gelu,
                                       fp8, prefix="visual.")
        self.tower = clip.VisionTower(self.train, heads, quick_gelu, fp8,
                                      prefix="visual.")

    @torch.no_grad()
    def anchors(self, images: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.frozen.encode(x) for x in images.split(CHUNK)])

    @torch.no_grad()
    def loss_rows(self, images: torch.Tensor, anchors: torch.Tensor
                  ) -> torch.Tensor:
        return torch.cat([clip.sq_distance(self.tower.encode(x), a)
                          for x, a in zip(images.split(CHUNK),
                                          anchors.split(CHUNK))])

    def attack(self, images, anchors, start, spec) -> torch.Tensor:
        """FARE's PGD on the trainable tower, a block of images at a time
        (each image's gradient is its own)."""
        frozen = [p.requires_grad_(False) for p in self.train.values()]
        try:
            return torch.cat([
                clip.pgd_linf(lambda x, a=a: clip.sq_distance(
                    self.tower.encode(x), a).mean(), x, s, spec["eps"],
                    spec["step"], spec["iterations"])
                for x, a, s in zip(images.split(CHUNK), anchors.split(CHUNK),
                                   start.split(CHUNK))])
        finally:
            for p in frozen:
                p.requires_grad_(True)

    def grads(self, adv, anchors, rows: Optional[int] = None):
        """The gradient of the mean loss over `rows` rows (all)."""
        rows = rows or len(adv)
        chunks = (clip.sq_distance(self.tower.encode(x), a).sum() / rows
                  for x, a in zip(adv[:rows].split(CHUNK),
                                  anchors[:rows].split(CHUNK)))
        return clip.grads_of(chunks, self.train)


def _optimizer(model: Model, spec: dict) -> clip.AdamW:
    return clip.AdamW(model.train, tuple(spec["betas"]), spec["eps_adam"],
                      {k: spec["wd"] for k in model.train})


def _lr(spec: dict, t: int) -> float:
    return clip.cosine_lr(spec["lr"], spec["warmup"], spec["steps"],
                          spec["start_step"] + t)


def judge(tensors: Dict[str, torch.Tensor], steps: List[dict],
          grad1: Dict[str, torch.Tensor], params3: Dict[str, torch.Tensor],
          spec: dict, heads: int, quick_gelu: bool) -> Dict[str, float]:
    model = Model(tensors, heads, quick_gelu)
    opt = _optimizer(model, spec)
    out = {"anchor_err": 0.0, "ball_excess": 0.0, "attack_gap": -1.0,
           "loss_err": 0.0}
    ref_grad1 = None
    for t, rec in enumerate(steps):
        x, adv = rec["images"], rec["adv"].float()
        anchors = model.anchors(x)
        a = rec["anchors"].float()
        err = (a - anchors).norm(dim=-1) / anchors.norm(dim=-1)
        out["anchor_err"] = max(out["anchor_err"], float(err.max()))
        excess = torch.stack([((adv - x).abs() - spec["eps"]).max(),
                              (-adv).max(), (adv - 1).max()]).max()
        out["ball_excess"] = max(out["ball_excess"], float(excess), 0.0)
        at_prog = float(model.loss_rows(adv, anchors).mean())
        ref_adv = model.attack(x, anchors, rec["start"], spec)
        at_ref = float(model.loss_rows(ref_adv, anchors).mean())
        out["attack_gap"] = max(out["attack_gap"], (at_ref - at_prog) / at_ref)
        out["loss_err"] = max(out["loss_err"],
                              abs(rec["loss"] - at_prog) / at_prog)
        grads = model.grads(adv, anchors)
        if t == 0:
            ref_grad1 = grads
        opt.step(grads, _lr(spec, t))
    out.update(compare_updates(
        tensors, grad1, ref_grad1, params3,
        {k: v.detach() for k, v in model.train.items()}))
    return out


class StandIn:
    """The reference in the program's place: the same images and starts,
    its own anchors, attack, loss, gradient and update.  `fp8` computes
    every product in fp8 (the control); `fault` plants "half" (the loss's
    mean over the first half of the rows alone) or "token" (the attack's
    answer replaced by its start: PGD skipped)."""

    def __init__(self, tensors, spec: dict, heads: int, quick_gelu: bool,
                 fp8: bool = False, fault: Optional[str] = None):
        self.spec = spec
        self.model = Model(tensors, heads, quick_gelu, fp8)
        self.opt = _optimizer(self.model, spec)
        self.fault = fault

    def run(self, inputs: List[dict]):
        m, steps, grad1 = self.model, [], None
        b1 = self.spec["betas"][0]
        for t, rec in enumerate(inputs):
            x, start = rec["images"], rec["start"]
            anchors = m.anchors(x)
            if self.fault == "token":
                adv = (x + start).clamp(0, 1)
            else:
                adv = m.attack(x, anchors, start, self.spec)
            rows = len(x) // 2 if self.fault == "half" else None
            loss = float(m.loss_rows(adv, anchors)[:rows].mean())
            self.opt.step(m.grads(adv, anchors, rows), _lr(self.spec, t))
            if t == 0:
                grad1 = {k: self.opt.m[k] / (1 - b1) for k in m.train}
            steps.append({"images": x, "start": start, "adv": adv,
                          "anchors": anchors, "loss": loss})
        params3 = {k: v.detach().clone() for k, v in m.train.items()}
        return steps, grad1, params3
