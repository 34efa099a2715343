"""ImageNet robust evaluation command line (port of
`leaf_tpu/evals/imagenet_robust.py`):

    python -m leaf_tpu_torch.evals.imagenet_robust --model ViT-H-14 \\
        --pretrained <checkpoint> --imagenet-root <val folder> \\
        --n-samples 1000 --eps 2 --output-dir ./imagenet_eval

The zero-shot classifier (80 templates x 1000 classes), clean top-1 on a
random `--n-samples` subset, then robust top-1 under the AutoAttack-style
cascade (APGD-CE and targeted APGD-DLR, `benchmark.zeroshot_
classification._apgd_attack_batch`), with `--square` the black-box Square
attack on the samples APGD did not fool (L-inf only).  Writes
`results.json` and, with `--save-adv`, the adversarial images `x_adv.npy`.
It runs on `--device` (default `cuda`).

Every product is fp32 with TF32 off, the classifier's text encodes too,
whatever `--precision` says: the JAX command line builds its scorer and
its logits in fp32 and reads `--precision` nowhere else.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from leaf_tpu_torch.utils.logging_utils import setup_logging

LOG = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser("leaf_tpu_torch ImageNet robust eval")
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--pretrained", type=str, default="")
    p.add_argument("--imagenet-root", type=str, required=True)
    p.add_argument("--n-samples", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--eps", type=float, default=2.0,
                   help="/255 units for linf/l2; absolute for l1 "
                        "(AutoAttack's L1 preset uses 75)")
    p.add_argument("--norm", default="linf", choices=["linf", "l2", "l1"])
    p.add_argument("--attack-iters", type=int, default=100)
    p.add_argument("--n-targets", type=int, default=3)
    p.add_argument("--square", action="store_true", default=False,
                   help="add the black-box Square attack for the samples "
                        "APGD did not fool (the full AutoAttack cascade)")
    p.add_argument("--square-iters", type=int, default=1000)
    p.add_argument("--precision", type=str, default="fp32",
                   help="read by nothing: the eval computes in fp32")
    p.add_argument("--output-dir", type=str, default="./imagenet_eval")
    p.add_argument("--save-adv", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run: 'cuda' (the default) or "
                        "'cpu'")
    return p.parse_args(argv)


def main(argv=None, seconds: Optional[Dict[str, float]] = None):
    """The eval; returns the results dict.  `seconds`, if given, collects
    the wall seconds of each part ("classifier", "clean", "apgd",
    "square"), each ending in a copy to the host."""
    args = parse_args(argv)
    setup_logging()
    if args.square and args.norm != "linf":
        # the Square stage searches the L-inf ball; inside an L1 or L2
        # eval it would count perturbations outside the threat model
        raise ValueError("--square is only defined for --norm linf")

    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.attacks.square import make_margin_loss_fn, square_attack
    from leaf_tpu_torch.benchmark.zeroshot_classification import (
        _apgd_attack_batch, _logits_fn)
    from leaf_tpu_torch.data.imagenet import get_imagenet
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                               local_checkpoint)
    from leaf_tpu_torch.models.preprocess import image_transform
    from leaf_tpu_torch.models.zero_shot import (build_zero_shot_classifier,
                                                 imagenet_classnames,
                                                 openai_imagenet_templates)

    clock = seconds if seconds is not None else {}

    def tick(name, t0):
        clock[name] = clock.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    model = create_model(args.model,
                         local_checkpoint(args.pretrained, "--pretrained",
                                          args.model),
                         precision="fp32", seed=args.seed, device=args.device,
                         master_weights=True)
    cfg, device = model.cfg, model.device
    model.module.requires_grad_(False)
    visual = model.module.visual
    scorer = CandidateScorer(cfg, device)
    preprocess = image_transform(cfg.vision.image_size, do_normalize=False)

    with fp32_products():
        LOG.info("building zero-shot classifier")
        t0 = time.perf_counter()
        classifier = build_zero_shot_classifier(
            lambda t: scorer.encode_text(model.module.text, t),
            get_tokenizer(args.model), imagenet_classnames(),
            openai_imagenet_templates(), num_classes_per_batch=10)
        if classifier.is_cuda:
            torch.cuda.synchronize(device)
        tick("classifier", t0)
    logits_fn = _logits_fn(visual, cfg, classifier)
    data = get_imagenet(args.imagenet_root, preprocess, "val",
                        batch_size=args.batch_size, n_val=args.n_samples,
                        seed=args.seed)
    eps = args.eps if args.norm == "l1" else args.eps / 255.0

    n = clean1 = robust1 = 0
    adv_batches = []
    t0 = time.perf_counter()
    for images, labels in data.loader:
        labels = np.asarray(labels)
        images_t = torch.from_numpy(np.ascontiguousarray(
            images, dtype=np.float32)).to(device)
        labels_t = torch.from_numpy(labels).to(device).long()
        with torch.no_grad():
            logits = logits_fn(images_t).cpu().numpy()
        correct = logits.argmax(-1) == labels
        clean1 += int(correct.sum())
        t0 = tick("clean", t0)
        adv, fooled = _apgd_attack_batch(
            visual, cfg, classifier, images_t, labels_t, eps,
            n_iter=args.attack_iters, n_targets=args.n_targets,
            norm=args.norm)
        fooled = fooled.cpu().numpy()
        adv = adv.cpu().numpy()
        t0 = tick("apgd", t0)
        if args.square and (~fooled).any():
            mfn = make_margin_loss_fn(logits_fn, labels, device)
            adv_sq = square_attack(mfn, np.asarray(images, np.float32),
                                   eps=args.eps / 255.0,
                                   n_iters=args.square_iters, seed=args.seed)
            fooled_sq = mfn(adv_sq)[1].cpu().numpy()
            # --save-adv keeps the example that fooled the model: Square's
            # successes replace the rows APGD failed on
            new_sq = fooled_sq & ~fooled
            adv[new_sq] = adv_sq[new_sq]
            fooled = fooled | fooled_sq
            t0 = tick("square", t0)
        robust1 += int((~fooled & correct).sum())
        if args.save_adv:
            adv_batches.append(adv)
        n += len(labels)
        LOG.info("progress %d/%d: clean %.4f robust %.4f", n,
                 args.n_samples, clean1 / n, robust1 / n)

    os.makedirs(args.output_dir, exist_ok=True)
    results = {
        "model": args.model, "pretrained": args.pretrained,
        "n_samples": n, "eps": args.eps,
        "clean_acc1": clean1 / max(n, 1),
        "robust_acc1": robust1 / max(n, 1),
    }
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if args.save_adv and adv_batches:
        np.save(os.path.join(args.output_dir, "x_adv.npy"),
                np.concatenate(adv_batches))
    LOG.info("results: %s", results)
    return results


if __name__ == "__main__":
    main()
