"""Where a LEAF training step's time goes on one CUDA GPU.

Usage, from the root of a checkout, on a machine with a card:
  python -m leaf_tpu_torch.profile_train [--out profile.json]

ViT-L-14-quickgelu text tower, bf16 compute on fp32 master weights, seed
0, batch 128, rho 50, k 1, AdamW at 1e-5: the fused attack+train step
(`train.fused.FusedLeafStep`, with the next batch's probes prepared right
after each step, as the loop does) and the unfused one
(`attack_text_leaf` + `train.step`), each on the synthetic caption
(bucket 16) and on seeded captions of 50 to 58 words (bucket 64).  Per
cell, by `profile_serve.profile_cell`: host-clock ms per step without the
profiler, then `torch.profiler` over a few steps, with the device's
kernel intervals merged into busy time and split by kernel family, and
the idle share against both windows.  The anchors of the fused cells come
from the cache (every batch of a cell holds the same captions).
"""
from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from leaf_tpu_torch.profile_serve import MODEL, card, profile_cell

BATCH, RHO = 128, 50
WORDS = ("a photo of the small large red blue green dog cat man woman child "
         "car street house tree river beach city park field table chair "
         "bird horse boat train plane sitting standing running near on "
         "under with in at old young bright dark happy").split()


def profile_train() -> list:
    from leaf_tpu_torch.attacks.engine import CandidateScorer, bucket_tokens
    from leaf_tpu_torch.attacks.text import attack_text_leaf
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import fused, optim, schedules, step

    model = create_model(MODEL, precision="bf16", seed=0, device="cuda",
                         master_weights=True)
    text = model.module.text
    frozen = copy.deepcopy(text).requires_grad_(False)
    opt = optim.make_optimizer(text.named_parameters(),
                               schedules.const_lr(1e-5, 0, 1),
                               weight_decay=1e-4)
    state = step.TrainState.create(text, opt)
    tok = get_tokenizer(MODEL)
    scorer = CandidateScorer(model.cfg, "cuda")
    anchor_encode, train_step = step.make_anchor_encode(), step.make_train_step()
    rng = np.random.default_rng(0)
    captions = {
        "bucket 16 ('Dummy caption')": ["Dummy caption"] * BATCH,
        "bucket 64 (50-58 words)": [
            " ".join(rng.choice(WORDS, size=int(rng.integers(50, 59))))
            for _ in range(BATCH)]}

    def put(tokens):
        return torch.from_numpy(np.ascontiguousarray(tokens)).cuda()

    rows = []
    for name, texts in captions.items():
        fs = fused.FusedLeafStep(model.cfg, tok, RHO, device="cuda")
        prepared = [None]

        def fused_step():
            fs(state, frozen, texts, rng, prepared=prepared[0])
            prepared[0] = fs.prepare_probes(texts, rng)

        def unfused_step():
            anchors = anchor_encode(frozen, put(bucket_tokens(tok(texts))))
            _, adv = attack_text_leaf(scorer, state.text, tok, texts, anchors,
                                      n=RHO, rng=rng)
            train_step(state, put(bucket_tokens(tok(adv))), anchors)

        rows.append(profile_cell(f"fused step, {name}", fused_step, 8,
                                 warm=2, profiled=3))
        rows.append(profile_cell(f"unfused step, {name}", unfused_step, 8,
                                 warm=2, profiled=3))
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    result = {"card": card(), "torch": torch.__version__,
              "train": profile_train()}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
