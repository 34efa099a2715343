"""Learning-rate schedules (port of `leaf_tpu/train/schedules.py`).

Pure step -> lr functions of a Python integer step, with the values of
the JAX package's schedules (OpenCLIP's).  Warmup is linear with lr(0) =
base_lr/warmup (the (step+1)/warmup form).
"""
from __future__ import annotations

import math


def const_lr(base_lr: float, warmup_length: int, steps: int):
    def schedule(step: int) -> float:
        if step < warmup_length:
            return base_lr * (step + 1) / max(warmup_length, 1)
        return base_lr
    return schedule


def cosine_lr(base_lr: float, warmup_length: int, steps: int):
    def schedule(step: int) -> float:
        if step < warmup_length:
            return base_lr * (step + 1) / max(warmup_length, 1)
        e = step - warmup_length
        es = max(steps - warmup_length, 1)
        return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr
    return schedule


def const_lr_cooldown(base_lr: float, warmup_length: int, steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0):
    def schedule(step: int) -> float:
        if step < warmup_length:
            return base_lr * (step + 1) / max(warmup_length, 1)
        start_cooldown = steps - cooldown_steps
        if step < start_cooldown:
            return base_lr
        e = step - start_cooldown
        es = max(steps - start_cooldown, 1)
        decay = (1 - min(max(e / es, 0.0), 1.0)) ** cooldown_power
        return decay * (base_lr - cooldown_end_lr) + cooldown_end_lr
    return schedule


def make_scheduler(name: str, base_lr: float, warmup_length: int, steps: int,
                   cooldown_steps: int = 0, cooldown_power: float = 1.0,
                   cooldown_end_lr: float = 0.0):
    """Scheduler by CLI name (`--lr-scheduler`)."""
    if name == "cosine":
        return cosine_lr(base_lr, warmup_length, steps)
    if name == "const":
        return const_lr(base_lr, warmup_length, steps)
    if name == "const-cooldown":
        return const_lr_cooldown(base_lr, warmup_length, steps,
                                 cooldown_steps, cooldown_power,
                                 cooldown_end_lr)
    raise ValueError(f"unknown scheduler {name!r}")
