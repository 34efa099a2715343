"""Where a FARE training step's time goes on one CUDA GPU.

Usage, from the root of a checkout, on a machine with a card:
  python -m leaf_tpu_torch.profile_fare [--out profile.json]

ViT-H-14's vision tower (random weights, seed 0) in bf16 on fp32 master
weights, a batch of 128 seeded 224 x 224 images, the step of
`scripts/train_fare_vith.sh` (PGD-10 L-inf at 2/255 with a step of 1/255,
AdamW at lr 1e-5 and wd 1e-4): the frozen tower's anchors, the attack and
the update, as `train.fare.train_fare` runs them, with block remat (the
default) and without.  Per cell, by `profile_serve.profile_cell`:
host-clock ms per step without the profiler (each step ends in a
synchronise), then `torch.profiler` over one step, the device's kernel
intervals merged into busy time and split by kernel family.
"""
from __future__ import annotations

import argparse
import copy
import json

import torch

from leaf_tpu_torch.profile_serve import card, profile_cell

MODEL, BATCH = "ViT-H-14", 128


def profile_fare() -> list:
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.train import fare

    model = create_model(MODEL, seed=0, device="cuda", master_weights=True)
    visual, cfg = model.module.visual, model.cfg
    visual.compute_dtype = torch.bfloat16
    frozen = copy.deepcopy(visual).requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(0)
    size = cfg.vision.image_size
    images = torch.rand(BATCH, size, size, 3, generator=g, device="cuda")
    targets = torch.zeros(BATCH, dtype=torch.long, device="cuda")
    rows = []
    for remat in (True, False):
        fcfg = fare.FareConfig(remat=remat)
        opt = fare.make_fare_optimizer(visual.parameters(), fcfg)
        attack = fare.make_fare_attack(visual, cfg, fcfg)
        train_step = fare.make_fare_train_step(visual, cfg, fcfg, opt)
        steps = [0]

        def step():
            with torch.no_grad():
                orig = fare.encode_vision(frozen, cfg, images,
                                          fcfg.output_normalize)
            adv = attack(images, orig, targets, None, g)
            train_step(steps[0], orig, images, adv, targets, None)
            steps[0] += 1
            torch.cuda.synchronize()

        rows.append(profile_cell(
            f"FARE step, {MODEL}, batch {BATCH}, "
            + ("remat" if remat else "no remat"), step, 2, warm=1,
            profiled=1))
        del opt, attack, train_step
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fare: CUDA is not available")
    result = {"card": card(), "torch": torch.__version__,
              "fare": profile_fare()}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
