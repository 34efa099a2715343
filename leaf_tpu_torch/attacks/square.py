"""Square Attack, L-inf (port of `leaf_tpu/attacks/square.py`).

A score-based random search (Andriushchenko et al., 2020): each iteration
moves a random square window of every sample that is not yet fooled to
+-eps per channel, and keeps the change where the sample's margin loss
improves.  Only forward passes touch the model, one margin-loss call per
iteration; the proposals are drawn on the host with numpy's
`default_rng(seed)`, the JAX package's draws in the same order, so the
same seed proposes the same squares.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def _p_selection(p_init: float, it: int, n_iters: int) -> float:
    """The published schedule of the share of pixels to perturb."""
    t = int(it / n_iters * 10000)
    if 10 < t <= 50:
        return p_init / 2
    if 50 < t <= 200:
        return p_init / 4
    if 200 < t <= 500:
        return p_init / 8
    if 500 < t <= 1000:
        return p_init / 16
    if 1000 < t <= 2000:
        return p_init / 32
    if 2000 < t <= 4000:
        return p_init / 64
    if 4000 < t <= 6000:
        return p_init / 128
    if 6000 < t <= 8000:
        return p_init / 256
    if t > 8000:
        return p_init / 512
    return p_init


def _host(pair):
    """Writable host copies of a margin function's (loss, fooled): the
    search assigns into them (the JAX package's `np.asarray` of a jax array
    is read-only, so its search fails at the first improvement)."""
    return tuple(np.array(t.detach().cpu() if isinstance(t, torch.Tensor)
                          else t) for t in pair)


def square_attack(
    margin_loss_fn: Callable,     # images [B,H,W,C] -> (loss [B], fooled [B])
    images: np.ndarray,           # [B, H, W, C] in [0, 1]
    eps: float = 8 / 255,
    n_iters: int = 1000,
    p_init: float = 0.8,
    seed: int = 0,
) -> np.ndarray:
    """The best adversarial images found, per sample (host arrays).
    `margin_loss_fn` takes a host array and returns tensors or arrays."""
    rng = np.random.default_rng(seed)
    x = np.asarray(images, np.float32)
    B, H, W, C = x.shape

    # start: vertical stripes of +-eps
    stripes = rng.choice([-eps, eps], size=(B, 1, W, C))
    x_best = np.clip(x + stripes, 0.0, 1.0).astype(np.float32)
    loss_best, fooled = _host(margin_loss_fn(x_best))

    for it in range(n_iters):
        active = ~fooled
        if not active.any():
            break
        p = _p_selection(p_init, it, n_iters)
        s = max(1, int(round(math.sqrt(p * H * W / 1))))
        s = min(s, H, W)
        x_new = x_best.copy()
        for b in np.where(active)[0]:
            r = rng.integers(0, H - s + 1)
            c = rng.integers(0, W - s + 1)
            delta = rng.choice([-eps, eps], size=(1, 1, C))
            window = x[b, r:r + s, c:c + s] + delta
            x_new[b, r:r + s, c:c + s] = np.clip(window, 0.0, 1.0)
            # stay within the eps-ball of x
            x_new[b] = np.clip(x_new[b], x[b] - eps, x[b] + eps)
            x_new[b] = np.clip(x_new[b], 0.0, 1.0)
        loss_new, fooled_new = _host(margin_loss_fn(x_new))
        improved = active & (loss_new > loss_best)
        x_best[improved] = x_new[improved]
        loss_best[improved] = loss_new[improved]
        fooled = fooled | fooled_new
    return x_best


def make_margin_loss_fn(logits_fn: Callable, labels, device=None):
    """(margin loss [B], fooled [B]) as tensors, from a logits function
    over images on `device` [B, ...] -> [B, K]; host images are copied
    there first."""
    labels = torch.as_tensor(np.asarray(labels), device=device).long()

    @torch.no_grad()
    def f(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        logits = logits_fn(x.to(device, torch.float32))
        is_true = torch.nn.functional.one_hot(
            labels, logits.shape[-1]).bool()
        other = logits.masked_fill(is_true, -math.inf).amax(dim=-1)
        true = logits.gather(1, labels[:, None])[:, 0]
        return other - true, other > true

    return f
