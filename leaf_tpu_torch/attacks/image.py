"""L-inf / L2 PGD image attacks (port of `leaf_tpu/attacks/image.py`).

  * `attack_image` / `attack_image_classification`: sign-gradient PGD
    with a uniform start, clipped to the eps-ball, in de-normalised pixel
    space;
  * `pgd`: FARE's momentum PGD (normalised gradient with momentum, L-inf
    or L2 projection, clamped to [0, 1]; NaN gradients zeroed).

Each attack is a plain autograd loop over `delta`: forward through the
vision tower, the input's gradient, a step.  On a card the forward runs
the towers' hand kernels and their backward recomputes through the
plain versions (`ops.packed_attention`).  Images are NHWC in [0, 1];
normalisation is folded into the loss.  The tower computes in its
weights' dtype (fp32 for the trainer's eval, as the JAX package's
default `dtype=float32`).  The random start is drawn from `generator`
(on the images' device), or given as `delta` (a test feeds the start
that `jax.random.uniform` drew).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.nn import functional as F

from leaf_tpu_torch.models.clip import VisionTower, l2_normalize
from leaf_tpu_torch.models.config import CLIPConfig
from leaf_tpu_torch.models.preprocess import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

_LINF = ("inf", "linf", "Linf")


def _normalize_images(x: torch.Tensor, cfg=None) -> torch.Tensor:
    """Pixel [0, 1] -> model input, with the config's preprocess
    statistics where it has them, else OpenAI CLIP's."""
    mean_v, std_v = OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
    if cfg is not None and getattr(cfg, "image_mean", None):
        mean_v = cfg.image_mean
        std_v = getattr(cfg, "image_std", None) or std_v
    mean = torch.tensor(mean_v, dtype=x.dtype, device=x.device)
    std = torch.tensor(std_v, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _encode(visual: VisionTower, cfg: CLIPConfig, images: torch.Tensor,
            normalize: bool) -> torch.Tensor:
    return visual.encode_image(_normalize_images(images, cfg), normalize)


def _uniform_start(images: torch.Tensor, eps: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(images.shape, generator=generator, dtype=images.dtype,
                   device=images.device)
    return eps * (2 * u - 1)


def _input_grad(loss_fn: Callable, delta: torch.Tensor) -> torch.Tensor:
    d = delta.detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(d)
    (g,) = torch.autograd.grad(loss, d)
    return g


def _sign_pgd(loss_fn: Callable, images: torch.Tensor, eps: float,
              n_steps: int, stepsize: Optional[float],
              generator: Optional[torch.Generator],
              delta: Optional[torch.Tensor]) -> torch.Tensor:
    """L-inf sign-gradient ascent of `loss_fn(delta)` from a uniform start
    (or `delta`), clipped to the eps-ball; returns `images + delta`."""
    stepsize = eps / n_steps if stepsize is None else stepsize
    if delta is None:
        delta = _uniform_start(images, eps, generator)
    for _ in range(n_steps):
        g = _input_grad(loss_fn, delta)
        delta = (delta.detach() + stepsize * g.sign()).clamp(-eps, eps)
    return images + delta


def attack_image(visual: VisionTower, cfg: CLIPConfig, images: torch.Tensor,
                 anchor_features: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 objective: str = "l2", eps: float = 2 / 255,
                 n_steps: int = 10, stepsize: Optional[float] = None,
                 delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding-objective PGD: maximise ||f(x+d) - a||^2 (l2) or
    -<f^, a^> (dissim) over ||d||inf <= eps, uniform start, sign-gradient
    steps.  `images` NHWC in [0, 1], before normalisation."""
    if objective not in ("l2", "dissim"):
        raise ValueError(f"attack_image objective must be 'l2' or "
                         f"'dissim', got {objective!r}")
    anchors = anchor_features.float()
    if objective == "dissim":
        anchors = l2_normalize(anchors)

    def loss_fn(d):
        feats = _encode(visual, cfg, images + d,
                        normalize=(objective == "dissim")).float()
        if objective == "l2":
            return (anchors - feats).square().sum()
        return -(anchors * feats).sum()

    return _sign_pgd(loss_fn, images, eps, n_steps, stepsize, generator,
                     delta)


def attack_image_classification(visual: VisionTower, cfg: CLIPConfig,
                                images: torch.Tensor,
                                classifier: torch.Tensor,
                                labels: torch.Tensor,
                                generator: Optional[torch.Generator] = None,
                                eps: float = 2 / 255, n_steps: int = 10,
                                stepsize: Optional[float] = None,
                                delta: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Zero-shot-classification PGD: maximise the cross-entropy of the
    normalised image features against the class-embedding matrix
    `classifier` [D, K]."""
    classifier = classifier.float()
    labels = labels.long()

    def loss_fn(d):
        feats = _encode(visual, cfg, images + d, normalize=True).float()
        return F.cross_entropy(feats @ classifier, labels)

    return _sign_pgd(loss_fn, images, eps, n_steps, stepsize, generator,
                     delta)


def _normalize_grad(g: torch.Tensor, norm: str) -> torch.Tensor:
    if norm in _LINF:
        return g.sign()
    flat = g.reshape(g.shape[0], -1)
    flat = flat / torch.linalg.vector_norm(
        flat, dim=1, keepdim=True).clamp_min(1e-12)
    return flat.reshape(g.shape)


def _project(delta: torch.Tensor, eps: float, norm: str) -> torch.Tensor:
    if norm in _LINF:
        return delta.clamp(-eps, eps)
    flat = delta.reshape(delta.shape[0], -1)
    norms = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    scale = torch.clamp(eps / norms.clamp_min(1e-12), max=1.0)
    return (flat * scale).reshape(delta.shape)


def pgd(loss_fn: Callable, images: torch.Tensor, norm: str, eps: float,
        iterations: int, stepsize: float, mode: str = "max",
        momentum: float = 0.9,
        perturbation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FARE momentum PGD.  `loss_fn(adv_images) -> scalar`; the gradient
    is normalised (sign for L-inf, unit L2 otherwise), accumulated with
    momentum, normalised again, stepped, projected to the eps-ball and
    clamped so that x + d stays in [0, 1].  NaN gradients are zeroed."""
    sign = {"max": 1.0, "min": -1.0}[mode]
    delta = torch.zeros_like(images) if perturbation is None else perturbation
    velocity = torch.zeros_like(images)
    for _ in range(iterations):
        g = _input_grad(lambda d: loss_fn(images + d), delta)
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        g = _normalize_grad(g, norm)
        velocity = _normalize_grad(momentum * velocity + g, norm)
        delta = delta.detach() + sign * stepsize * velocity
        delta = _project(delta, eps, norm)
        delta = (images + delta).clamp(0.0, 1.0) - images
    return images + delta
