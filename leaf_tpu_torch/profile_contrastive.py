"""Where a contrastive CLIP training step's time goes on one CUDA GPU.

Usage, from the root of a checkout, on a machine with a card:
  python -m leaf_tpu_torch.profile_contrastive [--out profile.json]

ViT-B-32 (random weights, seed 0), both towers in bf16 on fp32 master
weights, a batch of 256 seeded 224 x 224 images and 256 token rows of 3 to
30 random words (77-token context), already on the card; the step of
`python -m leaf_tpu_torch.train.contrastive_driver` with AdamW at lr 5e-4
and wd 0.2 (`train.contrastive.make_contrastive_train_step`: forward of
both towers, InfoNCE, backward recomputing through the plain versions,
the update).  By `profile_serve.profile_cell`: host-clock ms per step
without the profiler (each step ends in a synchronise), then
`torch.profiler` over one step after three, the device's kernel intervals
merged into busy time and split by kernel family.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from leaf_tpu_torch.profile_serve import _tokens, card, profile_cell

MODEL, BATCH = "ViT-B-32", 256


def profile_contrastive() -> list:
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.train.contrastive import (
        ContrastiveState, make_contrastive_train_step)
    from leaf_tpu_torch.train.optim import make_optimizer

    model = create_model(MODEL, precision="bf16", seed=0, device="cuda",
                         master_weights=True)
    module = model.module
    module.visual.compute_dtype = torch.bfloat16
    state = ContrastiveState(module, make_optimizer(
        module.named_parameters(), lambda step: 5e-4, weight_decay=0.2))
    g = torch.Generator(device="cuda").manual_seed(0)
    size = model.cfg.vision.image_size
    images = torch.randn(BATCH, size, size, 3, generator=g, device="cuda")
    tokens = torch.from_numpy(_tokens(np.random.default_rng(0), BATCH, 77,
                                      4, 40)).cuda()
    step_fn = make_contrastive_train_step()

    def step():
        step_fn(state, images, tokens)
        torch.cuda.synchronize()

    return [profile_cell(f"contrastive step, {MODEL}, batch {BATCH}, bf16",
                         step, 5, warm=3, profiled=1)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_contrastive: CUDA is not available")
    result = {"card": card(), "torch": torch.__version__,
              "contrastive": profile_contrastive()}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
