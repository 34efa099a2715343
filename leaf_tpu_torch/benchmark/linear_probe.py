"""Linear probe benchmark (port of `leaf_tpu/benchmark/linear_probe.py`):
freeze the image tower, extract normalised features once, train a
logistic-regression head on them with full-batch AdamW, report the test
accuracy and mean per-class recall.

`train_probe` is `optax.adamw` at the same hyper-parameters, as
`torch.optim.AdamW` (decay on the weight and the bias, betas 0.9/0.999,
eps 1e-8); it reports the loss of its last step, taken before that
step's update, as the JAX function does.  The initial weight is
0.01 x a standard normal draw from a `torch.Generator` seeded by `seed`,
unless `init_w` gives it.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from leaf_tpu_torch.benchmark.zeroshot_classification import (
    image_features, waited)
from leaf_tpu_torch.evals.zero_shot import _device, fp32_products
from leaf_tpu_torch.models.config import CLIPConfig


def extract_features(visual, cfg: CLIPConfig, loader,
                     seconds: Optional[Dict[str, float]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(normalised fp32 features [N, D], labels [N]) over an (images,
    labels) loader.  `seconds`, if given, gains the waits for the loader
    ("data") and the encodes ("features")."""
    clock = seconds if seconds is not None else {}
    feats, labels = [], []
    for images, lab in waited(loader, clock):
        t0 = time.perf_counter()
        feats.append(image_features(visual, cfg, images))
        labels.append(np.asarray(lab))
        clock["features"] = clock.get("features", 0.0) \
            + time.perf_counter() - t0
    return np.concatenate(feats), np.concatenate(labels)


def initial_weights(dim: int, n_classes: int, seed: int) -> torch.Tensor:
    """The probe's initial [D, C] weight: 0.01 x N(0, 1) from `seed`."""
    g = torch.Generator().manual_seed(seed)
    return 0.01 * torch.randn(dim, n_classes, generator=g)


def train_probe(features: np.ndarray, labels: np.ndarray, n_classes: int,
                lr: float = 0.1, weight_decay: float = 0.0,
                epochs: int = 100, seed: int = 0, device="cpu",
                init_w: Optional[np.ndarray] = None):
    """Full-batch AdamW logistic regression on `device`; returns
    ({"w": [D, C], "b": [C]} as numpy, the last step's loss)."""
    if epochs <= 0:
        raise ValueError(f"linear probe needs epochs > 0, got {epochs}")
    D = features.shape[1]
    w0 = initial_weights(D, n_classes, seed) if init_w is None else init_w
    w = torch.tensor(np.array(w0, np.float32), device=device,
                     requires_grad=True)
    b = torch.zeros(n_classes, device=device, requires_grad=True)
    opt = torch.optim.AdamW([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    X = torch.as_tensor(np.asarray(features, np.float32), device=device)
    y = torch.as_tensor(np.asarray(labels), device=device).long()
    loss = None
    with fp32_products():
        for _ in range(epochs):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(X @ w + b, y)
            loss.backward()
            opt.step()
    return ({"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()},
            float(loss.detach()))


def evaluate_linear_probe(
    visual,
    cfg: CLIPConfig,
    train_loader,
    test_loader,
    n_classes: int,
    lr: float = 0.1,
    weight_decays: Sequence[float] = (0.0,),
    epochs: int = 100,
    val_fraction: float = 0.2,
    seed: int = 0,
    fewshot_k: int = -1,
    init_w: Optional[np.ndarray] = None,
    seconds: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Feature extraction -> (optional) weight-decay search on a
    validation split -> the final probe -> test accuracy and mean
    per-class recall.  `fewshot_k > 0` keeps k training examples a class.
    Every probe starts from `init_w` when it is given.  `seconds`, if
    given, gains "data", "features" and "probe" (the trainings')."""
    clock = seconds if seconds is not None else {}
    Xtr, ytr = extract_features(visual, cfg, train_loader, clock)
    Xte, yte = extract_features(visual, cfg, test_loader, clock)
    if fewshot_k and fewshot_k > 0:
        rng = np.random.default_rng(seed)
        keep = []
        for c in np.unique(ytr):
            idx = np.nonzero(ytr == c)[0]
            rng.shuffle(idx)
            keep.extend(idx[:fewshot_k])
        keep = np.sort(np.asarray(keep))
        Xtr, ytr = Xtr[keep], ytr[keep]

    device = _device(visual)
    t0 = time.perf_counter()
    best_wd = weight_decays[0]
    if len(weight_decays) > 1:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(Xtr))
        n_val = max(1, int(val_fraction * len(Xtr)))
        vi, ti = idx[:n_val], idx[n_val:]
        best_acc = -1.0
        for wd in weight_decays:
            probe, _ = train_probe(Xtr[ti], ytr[ti], n_classes, lr, wd,
                                   epochs, seed, device, init_w)
            pred = (Xtr[vi] @ probe["w"] + probe["b"]).argmax(-1)
            acc = float((pred == ytr[vi]).mean())
            if acc > best_acc:
                best_acc, best_wd = acc, wd

    probe, final_loss = train_probe(Xtr, ytr, n_classes, lr, best_wd,
                                    epochs, seed, device, init_w)
    clock["probe"] = clock.get("probe", 0.0) + time.perf_counter() - t0
    pred = (Xte @ probe["w"] + probe["b"]).argmax(-1)
    acc = float((pred == yte).mean())
    per_class = []
    for c in range(n_classes):
        m = yte == c
        if m.any():
            per_class.append(float((pred[m] == c).mean()))
    return {"lp_acc1": acc,
            "lp_mean_per_class_recall": float(np.mean(per_class)),
            "lp_weight_decay": best_wd,
            "lp_train_loss": final_loss,
            "n_train": len(ytr), "n_test": len(yte)}
