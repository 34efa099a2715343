"""Optimizer construction (port of `leaf_tpu/train/optim.py`): AdamW with
a weight-decay mask, a schedule and gradient clipping.

The JAX package chains `clip_by_global_norm -> scale_by_adam ->
add_decayed_weights(mask) -> scale_by_learning_rate(schedule)`.  Here
that is `torch.optim.AdamW` over two parameter groups (decoupled decay
is `lr * wd * p` in both packages), whose learning rate is set from the
schedule before every update, after a clip written out below.

The decay mask is the JAX package's rule on parameter paths, applied to
the port's dotted state-dict names: weight decay applies to every
parameter that is not a LayerNorm gain or bias, another bias, the class
embedding or the logit scale.

Gradient accumulation (`accum_freq > 1`, optax `MultiSteps` there) is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

import torch

# Path components that put a parameter in the no-decay group.
_NO_DECAY_KEYS = {"ln_1", "ln_2", "ln_pre", "ln_post", "ln_final",
                  "logit_scale", "class_embedding", "bias", "scale"}


def is_decay_param(name: str) -> bool:
    """Whether weight decay applies to the parameter of this dotted name
    (`blocks.3.attn.qkv_w`, `ln_final.scale`, ...)."""
    for key in name.split("."):
        if key in _NO_DECAY_KEYS or key.endswith("_b") or key.endswith("_bias"):
            return False
    return True


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class Optimizer:
    """AdamW with its schedule and clip.  `update(step)` consumes the
    gradients that `backward()` left on the parameters."""
    adamw: torch.optim.AdamW
    schedule: Callable[[int], float]
    grad_clip_norm: Optional[float]

    def parameters(self) -> List[torch.Tensor]:
        return [p for g in self.adamw.param_groups for p in g["params"]]

    def update(self, step: int) -> torch.Tensor:
        """Clip, take one AdamW step at `schedule(step)` and clear the
        gradients.  Returns the gradients' global norm before clipping."""
        grads = [p.grad for p in self.parameters() if p.grad is not None]
        norm = global_norm(grads)
        if self.grad_clip_norm:
            # optax's clip_by_global_norm: g * max_norm / norm above the
            # threshold, untouched below it (torch's clip_grad_norm_ would
            # divide by norm + 1e-6)
            scale = torch.where(norm < self.grad_clip_norm,
                                torch.ones_like(norm),
                                self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        lr = float(self.schedule(step))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return norm


def make_optimizer(
    named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
    schedule: Callable[[int], float],
    weight_decay: float = 0.2,
    beta1: float = 0.9,
    beta2: float = 0.98,
    eps: float = 1e-6,
    grad_clip_norm: Optional[float] = None,
    accum_freq: int = 1,
) -> Optimizer:
    """AdamW over `named_parameters` with the JAX package's defaults
    (`eps=1e-6`, `beta2=0.98`) and decay groups; `schedule` maps the
    0-based update count to the learning rate."""
    if accum_freq > 1:
        raise NotImplementedError(
            "--accum-freq > 1 is not ported yet: ROADMAP 'Next, in order' "
            "item 3")
    decay, no_decay = [], []
    for name, p in named_parameters:
        (decay if is_decay_param(name) else no_decay).append(p)
    adamw = torch.optim.AdamW(
        [{"params": decay, "weight_decay": weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=float(schedule(0)), betas=(beta1, beta2), eps=eps)
    return Optimizer(adamw, schedule, grad_clip_norm)
