"""Auto-PGD (APGD), L-inf / L2 / L1 (port of `leaf_tpu/attacks/apgd.py`).

Momentum steps (a = 0.75), a per-sample step size halved where the loss
oscillates or stopped improving, at checkpoints whose interval shrinks by
3% of `n_iter` each time (floor 6%), restarts from the best point, and the
[0, 1] pixel box.  L1 is the sparse variant: top-k sign steps, the exact
projection onto the box and the L1 ball (`l1_projection`), and a step size
that follows the sparsity of the best point, at fixed checkpoints.

The JAX package runs the attack as one `lax.fori_loop` over fixed-shape
state and carries the checkpoint schedule as scalars under `jnp.where`.
Here it is a Python loop over tensors on the images' device.  The schedule
(the iteration counter and the checkpoint interval) depends on the
iteration alone, never on the data, so it stays in Python integers and
picks the branch on the host; everything that depends on the data is
tensors, selected with `torch.where`.  Nothing inside the loop reads a
value back to the host and no shape depends on the data.  There is no
random start, so the result is deterministic.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _l2_norm(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    z = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=-1)
    return z.reshape(-1, *([1] * (x.dim() - 1))) if keepdim else z


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` with tensor bounds."""
    return torch.minimum(torch.maximum(x, lo), hi)


def l1_projection(x: torch.Tensor, y: torch.Tensor, eps: float,
                  n_bisect: int = 60) -> torch.Tensor:
    """delta such that y + delta is the Euclidean projection of y onto
    {d : ||d||_1 <= eps, 0 <= x + d <= 1}.

    In KKT form d_i(lam) = clip(soft_threshold(y_i, lam), -x_i, 1 - x_i),
    with ||d(lam)||_1 falling as lam grows and lam = 0 the box-only clip;
    `n_bisect` halvings of [0, max |y|] find lam.  Entries with |y_i| <= lam
    come out exactly zero."""
    B = y.shape[0]
    yf = y.reshape(B, -1)
    lo_box = -x.reshape(B, -1)
    hi_box = 1.0 - x.reshape(B, -1)

    def d_of(lam):   # lam [B, 1]
        st = torch.sign(yf) * torch.clamp_min(yf.abs() - lam, 0.0)
        return _clip(st, lo_box, hi_box)

    def l1(d):
        return d.abs().sum(dim=-1, keepdim=True)

    zero = torch.zeros((B, 1), dtype=yf.dtype, device=yf.device)
    need = l1(d_of(zero)) > eps
    lo = zero
    hi = yf.abs().amax(dim=-1, keepdim=True)
    for _ in range(n_bisect):
        mid = (lo + hi) / 2.0
        too_big = l1(d_of(mid)) > eps
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    lam = torch.where(need, hi, zero)
    return (d_of(lam) - yf).reshape(y.shape)


def _check_oscillation(loss_steps: torch.Tensor, j: int, k: int, n_iter: int,
                       k3: float = 0.75) -> torch.Tensor:
    """[B] bool: at most a `k3` share of the last `k` steps up to step `j`
    improved the loss (indices wrap around `n_iter`, as the reference's)."""
    counter5 = torch.arange(n_iter, device=loss_steps.device)
    valid = counter5 < k
    idx_a = torch.remainder(j - counter5, n_iter)
    idx_b = torch.remainder(j - counter5 - 1, n_iter)
    improved = loss_steps[idx_a] > loss_steps[idx_b]
    t = (improved & valid[:, None]).sum(dim=0)
    return t <= k * k3


def _loss_and_grad(loss_fn: Callable, x: torch.Tensor):
    """Per-sample losses at `x` and the gradient of their sum."""
    xa = x.detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(xa)
    (g,) = torch.autograd.grad(loss.sum(), xa)
    return loss.detach(), g


def apgd(loss_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
         norm: str = "linf", eps: float = 4 / 255, n_iter: int = 10,
         initial_stepsize: Optional[float] = None,
         is_train: bool = False) -> torch.Tensor:
    """Maximise the per-sample `loss_fn(x_adv) -> [B]` over the eps-ball
    around `x` and return the best point of each sample.  `is_train` only
    changes L1's first top-k share (0.05 against 0.2)."""
    norm = (norm.lower().replace("l2", "L2").replace("linf", "Linf")
            .replace("l1", "L1"))
    if norm not in ("Linf", "L2", "L1"):
        raise ValueError(f"unsupported norm {norm}")
    B = x.shape[0]
    ones = (B,) + (1,) * (x.dim() - 1)
    n_fts = math.prod(x.shape[1:])
    dtype, device = x.dtype, x.device

    if norm == "L1":
        n_iter_2 = max(int(0.04 * n_iter), 1)   # fixed checkpoint gap
        n_iter_min = n_iter_2
        size_decr = 0
        init_topk = 0.05 if is_train else 0.2
        adasp_redstep, adasp_minstep = 1.5, 10.0
        alpha = 1.0
    else:
        n_iter_2 = max(int(0.22 * n_iter), 1)
        n_iter_min = max(int(0.06 * n_iter), 1)
        size_decr = max(int(0.03 * n_iter), 1)
        init_topk = 0.0
        alpha = 2.0
    thr_decr = 0.75
    if initial_stepsize is not None:
        alpha = initial_stepsize / eps

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    x_adv = x.clamp(0.0, 1.0)
    loss_best, grad = _loss_and_grad(loss_fn, x_adv)
    x_adv_old = x_best = x_adv
    grad_best = grad
    loss_best_last_check = loss_best
    reduced_last_check = full((B,), 1.0)
    loss_steps = full((n_iter, B), 0.0)
    step_size = full(ones, alpha * eps)
    topk = full((B,), init_topk)
    sp_old = full((B,), float(n_fts))
    counter3, k = 0, n_iter_2

    def project(x_adv_1):
        if norm == "Linf":
            return _clip(x_adv_1, x - eps, x + eps).clamp(0.0, 1.0)
        delta = x_adv_1 - x
        dn = _l2_norm(delta) + 1e-12
        scale = torch.clamp_max(_l2_norm(delta), eps) / dn
        return (x + delta * scale).clamp(0.0, 1.0)

    def l1_step():
        """Sparse sign step and the exact box + L1 projection; no momentum
        for L1."""
        ga = grad.abs().reshape(B, -1)
        sorted_ga = torch.sort(ga, dim=-1).values            # ascending
        idx = ((1.0 - topk) * n_fts).long().clamp(0, n_fts - 1)
        thr = sorted_ga.gather(1, idx[:, None])
        sparse = grad * (grad.abs() >= thr.reshape(ones))
        sgn = torch.sign(sparse)
        denom = sgn.abs().reshape(B, -1).sum(dim=-1) + 1e-10
        x_adv_1 = x_adv + step_size * sgn / denom.reshape(ones)
        delta_u = x_adv_1 - x
        return x + delta_u + l1_projection(x, delta_u, eps)

    for i in range(n_iter):
        if norm == "L1":
            x_adv_1 = l1_step()
        else:
            a = 0.75 if i > 0 else 1.0
            grad2 = x_adv - x_adv_old
            if norm == "Linf":
                step = step_size * torch.sign(grad)
            else:
                step = step_size * grad / (_l2_norm(grad) + 1e-12)
            x_adv_1 = project(x_adv + step)
            x_adv_1 = project(x_adv + (x_adv_1 - x_adv) * a
                              + grad2 * (1 - a))

        # the last iteration's gradient is never used: no backward there
        if i < n_iter - 1:
            loss, grad_1 = _loss_and_grad(loss_fn, x_adv_1)
        else:
            with torch.no_grad():
                loss = loss_fn(x_adv_1)
            grad_1 = torch.zeros_like(x_adv_1)

        better = loss > loss_best
        bsel = better.reshape(ones)
        x_best = torch.where(bsel, x_adv_1, x_best)
        grad_best = torch.where(bsel, grad_1, grad_best)
        loss_best = torch.where(better, loss, loss_best)
        loss_steps[i] = loss

        x_adv_old = x_adv
        x_adv, grad = x_adv_1, grad_1
        counter3 += 1
        if counter3 != k:
            continue
        counter3 = 0
        if norm == "L1":
            # step size follows the best point's sparsity; k stays fixed
            sp_curr = ((x_best - x).abs() > 1e-10).reshape(B, -1).sum(
                dim=-1).to(dtype)
            fl_red = (sp_curr / sp_old) < 0.95
            topk = sp_curr / n_fts / 1.5
            new_step = torch.where(fl_red.reshape(ones), alpha * eps,
                                   step_size / adasp_redstep)
            step_size = new_step.clamp(alpha * eps / adasp_minstep,
                                       alpha * eps)
            hsel = fl_red.reshape(ones)
            sp_old = sp_curr
        else:
            osc = _check_oscillation(loss_steps, i, k, n_iter, thr_decr)
            no_impr = (1.0 - reduced_last_check) * (
                loss_best_last_check >= loss_best)
            halve = torch.maximum(osc.to(dtype), no_impr)
            hsel = halve.reshape(ones) > 0
            step_size = torch.where(hsel, step_size / 2.0, step_size)
            reduced_last_check = halve
            loss_best_last_check = loss_best
            k = max(k - size_decr, n_iter_min)
        x_adv = torch.where(hsel, x_best, x_adv)
        grad = torch.where(hsel, grad_best, grad)
    return x_best


# -- classification losses for the AutoAttack-style eval ---------------------

def ce_loss_fn(logits_fn: Callable, y: torch.Tensor):
    """Per-sample cross-entropy (APGD-CE's loss)."""
    def f(x_adv):
        logp = torch.log_softmax(logits_fn(x_adv), dim=-1)
        return -logp.gather(1, y.long()[:, None])[:, 0]
    return f


def dlr_targeted_loss_fn(logits_fn: Callable, y: torch.Tensor,
                         y_target: torch.Tensor):
    """Targeted DLR loss (APGD-T's): -(z_y - z_t) / (z_pi1 - (z_pi3 +
    z_pi4) / 2)."""
    def f(x_adv):
        logits = logits_fn(x_adv)
        sorted_z = torch.sort(logits, dim=-1, descending=True).values
        z_y = logits.gather(1, y.long()[:, None])[:, 0]
        z_t = logits.gather(1, y_target.long()[:, None])[:, 0]
        denom = sorted_z[:, 0] - (sorted_z[:, 2] + sorted_z[:, 3]) / 2 + 1e-12
        return -(z_y - z_t) / denom
    return f
