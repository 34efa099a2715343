"""The LEAF training step (port of `leaf_tpu/train/step.py`).

Everything after the attack: adversarial encode, TextFARE MSE loss,
backward, AdamW update.  The frozen anchor tower is a second `TextTower`
(a copy made before training) through the same forward; only the
trainable text tower has optimizer state, and the vision tower never
enters the step.

The JAX step is one jitted function of a parameter pytree; here the
state holds the tower itself, which the optimizer updates in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Tuple

import torch

from leaf_tpu_torch.models.clip import CLIP, TextTower
from leaf_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    """Trainable text tower, its optimizer and the count of updates."""
    text: TextTower
    optimizer: Optimizer
    step: int = 0

    @classmethod
    def create(cls, text: TextTower, optimizer: Optimizer) -> "TrainState":
        return cls(text=text, optimizer=optimizer, step=0)


def textfare_loss(text: TextTower, adv_tokens: torch.Tensor,
                  anchor_features: torch.Tensor, normalize: bool = False,
                  remat: bool = False,
                  w_fare_text: float = 1.0) -> torch.Tensor:
    """TextFARE objective: w * MSE(anchor, f(adv)).sum(-1).mean(), the
    difference taken in fp32."""
    feats = text.encode_text(adv_tokens, normalize, remat=remat)
    diff = anchor_features.float() - feats.float()
    return w_fare_text * diff.square().sum(dim=-1).mean()


def make_train_step(normalize: bool = False, remat: bool = False,
                    w_fare_text: float = 1.0) -> Callable:
    """Build the train step.

    step(state, adv_tokens [B, C], anchor_features [B, D])
      -> (state, metrics {loss, grad_norm}), both metrics tensors on the
    tower's device (reading one waits for the device).  The state is
    updated in place and returned."""

    def step_fn(state: TrainState, adv_tokens: torch.Tensor,
                anchor_features: torch.Tensor
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss = textfare_loss(state.text, adv_tokens, anchor_features,
                             normalize, remat, w_fare_text)
        loss.backward()
        grad_norm = state.optimizer.update(state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step_fn


def make_anchor_encode(normalize: bool = False) -> Callable:
    """Frozen-tower anchor encode, without gradients."""

    @torch.no_grad()
    def encode(frozen_text: TextTower, tokens: torch.Tensor) -> torch.Tensor:
        return frozen_text.encode_text(tokens, normalize)

    return encode


def clamp_logit_scale(model: CLIP) -> None:
    """Clamp logit_scale to [0, ln 100], in place.  The TextFARE loss
    gives it no gradient and it is not in the trainable tower, so the
    trainer has nothing to clamp; kept for the objectives that train it."""
    with torch.no_grad():
        model.logit_scale.clamp_(0.0, math.log(100.0))
