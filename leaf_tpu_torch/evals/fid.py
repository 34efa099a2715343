"""Frechet distance between real and generated image sets (port of
`leaf_tpu/evals/fid.py`).

The distance is exact: the trace of the geometric-mean term comes from
the eigenvalues of a symmetric product, with no `sqrtm`.  The features
are pluggable:

  * `clip`: the port's vision tower, unnormalised, in fp32 (clean-fid's
    CLIP-FID mode, which needs no Inception weights);
  * `inception`: torchvision's InceptionV3 pool features where torchvision
    and its weights are present; `make_inception_feature_fn` returns None
    otherwise, as the JAX one does, and the caller falls back to `clip`.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

LOG = logging.getLogger(__name__)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + tr(S1 + S2 - 2 (S1^1/2 S2 S1^1/2)^1/2), the
    trace of the last term as the sum of the square roots of its
    eigenvalues (float64, numpy)."""
    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    diff = mu1 - mu2
    s1 = sigma1 + eps * np.eye(sigma1.shape[0])
    s2 = sigma2 + eps * np.eye(sigma2.shape[0])
    w, v = np.linalg.eigh(s1)
    a = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    m = a @ s2 @ a
    m = (m + m.T) / 2
    tr_covmean = float(np.sqrt(np.clip(np.linalg.eigvalsh(m), 0, None)).sum())
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * tr_covmean)


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def make_clip_feature_fn(model, batch_size: int = 64) -> Callable:
    """CLIP image-tower features of [N, H, W, 3] images in [0, 1], not
    normalised: the port's `CLIPModel` `model` on its device, in its
    precision (fp32 as `clipscore.main` builds it)."""
    from leaf_tpu_torch.attacks.image import _normalize_images

    def features(images: np.ndarray) -> np.ndarray:
        out = []
        with torch.inference_mode():
            for i in range(0, len(images), batch_size):
                x = torch.as_tensor(np.asarray(images[i:i + batch_size],
                                               np.float32),
                                    device=model.device)
                out.append(model.module.encode_image(
                    _normalize_images(x, model.cfg)).float().cpu().numpy())
        return (np.concatenate(out) if out
                else np.zeros((0, model.cfg.embed_dim), np.float32))

    return features


def make_inception_feature_fn(batch_size: int = 32) -> Optional[Callable]:
    """InceptionV3 pool features (classic FID); None when torchvision or
    its weights are not available locally (the JAX package's soft path)."""
    try:
        import torchvision
        net = torchvision.models.inception_v3(weights="DEFAULT")
    except Exception as e:  # noqa: BLE001
        LOG.warning("inception weights unavailable (%r); "
                    "use the CLIP feature mode", e)
        return None
    net.fc = torch.nn.Identity()
    net.eval()

    def features(images: np.ndarray) -> np.ndarray:
        out = []
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
        with torch.no_grad():
            for i in range(0, len(images), batch_size):
                x = torch.from_numpy(
                    images[i:i + batch_size].transpose(0, 3, 1, 2)).float()
                x = torch.nn.functional.interpolate(
                    x, size=(299, 299), mode="bilinear", align_corners=False)
                out.append(net((x - mean) / std).numpy())
        return np.concatenate(out)

    return features


def compute_fid(real_images: np.ndarray, fake_images: np.ndarray,
                feature_fn: Callable) -> float:
    """FID between two image sets ([N, H, W, 3] float in [0, 1])."""
    mu1, s1 = feature_statistics(feature_fn(real_images))
    mu2, s2 = feature_statistics(feature_fn(fake_images))
    return frechet_distance(mu1, s1, mu2, s2)
