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

Locking (`train.locking`): a parameter of multiplier 0 goes to a group
whose learning rate is scaled by 0 (`lr_scale`), so that neither Adam's
step nor the decay moves it, while its gradient still counts in the clip's
global norm and Adam's moments still follow it: the JAX package's update
mask chained after the whole chain.

Gradient accumulation (`accum_freq = k > 1`) has the meaning of optax's
`MultiSteps(tx, every_k_schedule=k)`: the gradients of k calls are
averaged (as a running mean, in the same order of operations), the chain
above is applied to the average on the k-th call, the parameters stay
unchanged on the others, and the schedule counts applied updates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Mapping, Optional, Tuple

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
    """AdamW with its schedule, clip and accumulation.  `update(step)`
    consumes the gradients that `backward()` left on the parameters."""
    adamw: torch.optim.AdamW
    schedule: Callable[[int], float]
    grad_clip_norm: Optional[float]
    accum_freq: int = 1
    # running mean of the gradients since the last applied update
    # (accum_freq > 1 only; None right after an applied update)
    accumulated: Optional[List[torch.Tensor]] = None

    def parameters(self) -> List[torch.Tensor]:
        return [p for g in self.adamw.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        """AdamW's moments and step counts, and the accumulated gradients."""
        return {"adamw": self.adamw.state_dict(),
                "accumulated": self.accumulated}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        acc = state["accumulated"]
        if acc is not None:
            acc = [a.to(p.device, p.dtype)
                   for a, p in zip(acc, self.parameters())]
        self.accumulated = acc

    def _accumulate(self, mini_step: int) -> None:
        """Fold the parameters' gradients into the running mean, as
        optax's `acc + (g - acc) / (mini_step + 1)`."""
        grads = [p.grad for p in self.parameters()]
        if any(g is None for g in grads):
            raise RuntimeError("gradient accumulation needs a gradient on "
                               "every parameter at every call")
        if self.accumulated is None:
            self.accumulated = [torch.zeros_like(g) for g in grads]
        torch._foreach_sub_(grads, self.accumulated)
        torch._foreach_div_(grads, float(mini_step + 1))
        torch._foreach_add_(self.accumulated, grads)

    def update(self, step: int) -> torch.Tensor:
        """`step` counts the calls so far.  Clip, take one AdamW step at
        `schedule(step // accum_freq)` and clear the gradients; under
        accumulation only every `accum_freq`-th call does that, on the
        mean of the gradients since the last one.  Returns the global
        norm of this call's gradients before clipping."""
        grads = [p.grad for p in self.parameters() if p.grad is not None]
        norm = clip_norm = global_norm(grads)
        if self.accum_freq > 1:
            mini_step = step % self.accum_freq
            self._accumulate(mini_step)
            if mini_step != self.accum_freq - 1:
                self.adamw.zero_grad(set_to_none=True)
                return norm
            grads, self.accumulated = self.accumulated, None
            for p, g in zip(self.parameters(), grads):
                p.grad = g
            clip_norm = global_norm(grads)
        if self.grad_clip_norm:
            # optax's clip_by_global_norm: g * max_norm / norm above the
            # threshold, untouched below it (torch's clip_grad_norm_ would
            # divide by norm + 1e-6)
            scale = torch.where(clip_norm < self.grad_clip_norm,
                                torch.ones_like(clip_norm),
                                self.grad_clip_norm / clip_norm)
            torch._foreach_mul_(grads, scale)
        lr = float(self.schedule(step // self.accum_freq))
        for group in self.adamw.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)
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
    multipliers: Optional[Mapping[str, float]] = None,
) -> Optimizer:
    """AdamW over `named_parameters` with the JAX package's defaults
    (`eps=1e-6`, `beta2=0.98`) and decay groups; `schedule` maps the
    0-based count of applied updates to the learning rate.  `multipliers`
    ({name: 0.0 or 1.0}, `train.locking`) locks the parameters of 0."""
    if accum_freq < 1:
        raise ValueError(f"accum_freq must be at least 1, got {accum_freq}")
    # (decay, lr_scale) -> parameters; the two trainable groups always
    # exist, the locked ones where they have parameters
    groups = {(True, 1.0): [], (False, 1.0): []}
    for name, p in named_parameters:
        scale = 1.0 if multipliers is None else float(multipliers[name])
        if scale not in (0.0, 1.0):
            raise ValueError(f"{name}: multiplier {scale}, not 0 or 1")
        groups.setdefault((is_decay_param(name), scale), []).append(p)
    adamw = torch.optim.AdamW(
        [{"params": params, "weight_decay": weight_decay if decay else 0.0,
          "lr_scale": scale}
         for (decay, scale), params in groups.items()
         if params or scale == 1.0],
        lr=float(schedule(0)), betas=(beta1, beta2), eps=eps)
    return Optimizer(adamw, schedule, grad_clip_norm, accum_freq)
