"""The LEAF cells' judge: the reference follows the program's first steps
and holds what the program produced against it.

The program hands over, for each checked step, what it drew and chose:
the probe slots (`positions`), the slot it chose (`best_pos`), the
characters it drew (`us`), the candidate it chose (`best`), its loss and
its anchors; after the first step its optimizer's first moment (the
gradient, as AdamW got it) and after the last its parameters.  The
reference works out again everything the program derived from the
captions (the edited strings, the constraint, the tokens, the anchors,
every candidate's loss, the chosen caption's loss and gradient, AdamW's
update, all in float32), judges each choice by how far its loss lies below
the best one's, and follows the program's choices, so that a near tie
that bf16 breaks the other way does not fork the two runs.

`StandIn` puts the reference in the program's place: in fp8 (the
control) or with a planted fault.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import clip
from portbench.reference.text import (EDIT_VOCAB, Constraint, apply_edit,
                                      tokenizer)

SPACE = ord(" ")


def no_decay(name: str) -> bool:
    """OpenCLIP's rule: no weight decay on LayerNorm parameters, biases,
    embeddings of a single vector and the logit scale."""
    parts = name.split(".")
    return (any(p.startswith("ln_") for p in parts) or name.endswith("bias")
            or "class_embedding" in name or "logit_scale" in name)


def edited_rows(texts, positions, best_pos, us, constraint):
    """Probe strings [B][rho] (a space written at each drawn slot) and
    candidate strings [B][rho] (each drawn character at the chosen slot),
    invalid edits replaced by the clean caption."""
    probes, cands = [], []
    for i, text in enumerate(texts):
        p = [apply_edit(text, int(z), SPACE) for z in positions[i]]
        c = [apply_edit(text, int(best_pos[i]), EDIT_VOCAB[int(u)])
             for u in us[i]]
        if constraint is not None:
            p, c = constraint.apply(text, p), constraint.apply(text, c)
        probes.append(p)
        cands.append(c)
    return probes, cands


def token_lengths(rows: List[List[str]]) -> np.ndarray:
    tok = tokenizer()
    return np.array([tok.length(s) for r in rows for s in r])


class Model:
    """The trainable text tower and the frozen one, over OpenCLIP tensors."""

    def __init__(self, tensors: Dict[str, torch.Tensor], heads: int,
                 quick_gelu: bool, fp8: bool = False):
        frozen = {k: v.clone() for k, v in tensors.items()}
        self.train = {k: v.clone().requires_grad_(True)
                      for k, v in tensors.items()}
        self.frozen = clip.TextTower(frozen, heads, quick_gelu, fp8)
        self.tower = clip.TextTower(self.train, heads, quick_gelu, fp8)
        self.device = next(iter(tensors.values())).device

    def tokens(self, texts: List[str]) -> torch.Tensor:
        return torch.from_numpy(tokenizer()(texts)).to(self.device)

    @torch.no_grad()
    def losses(self, rows: List[List[str]], anchors: torch.Tensor
               ) -> torch.Tensor:
        """[B, rho] squared distances of every row's candidates' features
        to the row's anchor."""
        B, n = len(rows), len(rows[0])
        feats = self.tower.encode_rows(
            self.tokens([s for r in rows for s in r]))
        return clip.sq_distance(feats.reshape(B, n, -1), anchors[:, None])


def leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves the comparisons take: each tensor, but the attention's
    packed in-projection as its three projections (q, k, v), since the
    key's bias has no gradient under softmax and moves by round-off
    alone."""
    out = {}
    for k, v in tensors.items():
        if k.endswith(("in_proj_weight", "in_proj_bias")):
            for part, chunk in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}.{part}"] = chunk
        else:
            out[k] = v
    return out


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names) -> float:
    """The worst leaf's gap of norms, |norm(prog) - norm(ref)| over the
    larger of the reference leaf's norm and the median leaf's."""
    pn = {k: float(prog[k].float().norm()) for k in names}
    rn = {k: float(ref[k].float().norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def compare_updates(tensors, grad1, ref_grad1, params3, ref_params3
                    ) -> Dict[str, float]:
    """grad_leaf: the first gradient's worst leaf; delta_leaf: the
    parameters' change after the checked steps, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    g, rg = leaves(grad1), leaves(ref_grad1)
    names = list(rg)
    gnorm = {k: float(rg[k].norm()) for k in names}
    med = float(np.median(list(gnorm.values())))
    moved = [k for k in names if gnorm[k] >= 1e-3 * med]
    delta = leaves({k: params3[k] - tensors[k] for k in tensors})
    ref_delta = leaves({k: ref_params3[k] - tensors[k] for k in tensors})
    return {"grad_leaf": leaf_gap(g, rg, names),
            "delta_leaf": leaf_gap(delta, ref_delta, moved)}


def judge(tensors: Dict[str, torch.Tensor], steps: List[dict],
          grad1: Dict[str, torch.Tensor], params3: Dict[str, torch.Tensor],
          spec: dict, heads: int, quick_gelu: bool) -> Dict[str, float]:
    """The numbers compared; `steps` as `StandIn.run` returns them."""
    constraint = (Constraint(tokenizer().whole_words())
                  if spec["constrain"] else None)
    model = Model(tensors, heads, quick_gelu)
    opt = clip.AdamW(model.train, tuple(spec["betas"]), spec["eps"],
                     {k: 0.0 if no_decay(k) else spec["wd"]
                      for k in model.train})
    out = {"anchor_err": 0.0, "probe_gap": 0.0, "cand_gap": 0.0,
           "loss_err": 0.0}
    ref_grad1 = None
    for t, rec in enumerate(steps):
        texts = rec["texts"]
        with torch.no_grad():
            anchors = model.frozen.encode(model.tokens(texts))
        if rec.get("anchors") is not None:
            a = rec["anchors"].float().to(anchors.device)
            err = (a - anchors).norm(dim=-1) / anchors.norm(dim=-1)
            out["anchor_err"] = max(out["anchor_err"], float(err.max()))
        probes, cands = edited_rows(texts, rec["positions"], rec["best_pos"],
                                    rec["us"], constraint)
        lp = model.losses(probes, anchors).cpu().numpy()
        chosen = np.array([lp[i][rec["positions"][i] == rec["best_pos"][i]]
                           .max() for i in range(len(texts))])
        out["probe_gap"] = max(out["probe_gap"], _gap(lp, chosen))
        lc = model.losses(cands, anchors).cpu().numpy()
        chosen = lc[np.arange(len(texts)), rec["best"]]
        out["cand_gap"] = max(out["cand_gap"], _gap(lc, chosen))
        adv = [cands[i][int(rec["best"][i])] for i in range(len(texts))]
        feats = model.tower.encode_rows(model.tokens(adv))
        loss = clip.sq_distance(feats, anchors).mean()
        grads = clip.grads_of([loss], model.train)
        value = float(loss.detach())
        out["loss_err"] = max(out["loss_err"],
                              abs(rec["loss"] - value) / value)
        if t == 0:
            ref_grad1 = grads
        opt.step(grads, clip.cosine_lr(spec["lr"], spec["warmup"],
                                       spec["schedule_steps"],
                                       spec["start_step"] + t))
    out.update(compare_updates(
        tensors, grad1, ref_grad1, params3,
        {k: v.detach() for k, v in model.train.items()}))
    return out


def _gap(losses: np.ndarray, chosen: np.ndarray) -> float:
    """Widest row gap of a choice below the row's best loss, over the
    median row's best."""
    best = losses.max(axis=1)
    scale = max(float(np.median(best)), 1e-30)
    return float(((best - chosen) / scale).max())


class StandIn:
    """The reference in the program's place: the same captions, slots and
    characters, its own choices, loss, gradient and AdamW update.  `fp8`
    computes every product in fp8 (the control); `fault` plants one of
    "half" (the loss's mean over the first half of the rows alone) or
    "token" (the worst candidate taken in place of the best)."""

    def __init__(self, tensors, spec: dict, heads: int, quick_gelu: bool,
                 fp8: bool = False, fault: Optional[str] = None):
        self.tensors = tensors
        self.spec = spec
        self.model = Model(tensors, heads, quick_gelu, fp8)
        self.fault = fault
        self.constraint = (Constraint(tokenizer().whole_words())
                           if spec["constrain"] else None)
        self.opt = clip.AdamW(self.model.train, tuple(spec["betas"]),
                              spec["eps"],
                              {k: 0.0 if no_decay(k) else spec["wd"]
                               for k in self.model.train})

    def run(self, inputs: List[dict]):
        """`inputs`: each step's texts, positions and us.  Returns (steps,
        grad1, params3) in the form `judge` takes."""
        m, steps, grad1 = self.model, [], None
        b1 = self.spec["betas"][0]
        for t, rec in enumerate(inputs):
            texts, positions, us = rec["texts"], rec["positions"], rec["us"]
            with torch.no_grad():
                anchors = m.frozen.encode(m.tokens(texts))
            probes, _ = edited_rows(texts, positions, positions[:, 0], us,
                                    self.constraint)
            lp = m.losses(probes, anchors).cpu().numpy()
            best_pos = positions[np.arange(len(texts)), lp.argmax(axis=1)]
            _, cands = edited_rows(texts, positions, best_pos, us,
                                   self.constraint)
            lc = m.losses(cands, anchors).cpu().numpy()
            best = lc.argmin(axis=1) if self.fault == "token" \
                else lc.argmax(axis=1)
            adv = [cands[i][int(best[i])] for i in range(len(texts))]
            feats = m.tower.encode_rows(m.tokens(adv))
            per_row = clip.sq_distance(feats, anchors)
            if self.fault == "half":
                per_row = per_row[:len(texts) // 2]
            loss = per_row.mean()
            grads = clip.grads_of([loss], m.train)
            self.opt.step(grads, clip.cosine_lr(
                self.spec["lr"], self.spec["warmup"],
                self.spec["schedule_steps"], self.spec["start_step"] + t))
            if t == 0:
                grad1 = {k: self.opt.m[k] / (1 - b1) for k in m.train}
            steps.append({"texts": texts, "positions": positions, "us": us,
                          "best_pos": best_pos, "best": best,
                          "loss": float(loss.detach()), "anchors": anchors})
        params3 = {k: v.detach().clone() for k, v in m.train.items()}
        return steps, grad1, params3
