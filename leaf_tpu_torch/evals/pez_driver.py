"""PEZ prompt-inversion command line (port of
`leaf_tpu/evals/pez_driver.py`): invert a caption's text embedding, or
the embedding of target image(s), back into a discrete prompt, recording
the reconstruction, its cosine similarity and its token ids.

  python -m leaf_tpu_torch.evals.pez_driver --config pez_config.json \\
      --model ViT-L-14 --pretrained ckpt.safetensors \\
      --captions captions.txt --n-samples 10 --iter 300 \\
      --output results_inversions/ [--device cuda]

  # one prompt optimised across all the target images
  python -m leaf_tpu_torch.evals.pez_driver --images a.npy b.jpg \\
      --model ViT-L-14 --prompt-len 16 --iter 1000

A JSON config merges under the flags: defaults < the config < the flags
given.  The output is the JAX command line's
`results-<n>smpls-<iter>iters-<model>.json`; its `config` has `device`
besides.  Images are read by `models.preprocess.read_image` (`.npy` with
numpy, encoded images with Pillow).  It runs on `--device` (default
`cuda`).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import List, Optional

import numpy as np

from leaf_tpu_torch.utils.logging_utils import setup_logging

LOG = logging.getLogger(__name__)

# every flag's default lives here, so that the merge order (defaults <
# json < the flags given) holds: the parser's defaults are all None
DEFAULTS = dict(seed=0, prompt_len="match", lr=0.1, weight_decay=0.1,
                loss_weight=1.0, iter=3000, batch_size=1,
                model="ViT-L-14", pretrained="", n_samples=10,
                output="./results_inversions", device="cuda")


def _optimize(text, target, prompt_len: int, args) -> dict:
    from leaf_tpu_torch.evals.pez import optimize_prompt
    return optimize_prompt(text, target, prompt_len=prompt_len,
                           iters=args.iter, lr=args.lr,
                           weight_decay=args.weight_decay,
                           loss_weight=args.loss_weight, seed=args.seed)


def run_one_inversion(caption: str, module, tokenizer, args) -> dict:
    """Invert the caption's own text embedding (the frozen tower's)."""
    import torch

    from leaf_tpu_torch.evals.zero_shot import fp32_products

    text = module.text
    tokens = tokenizer([caption])
    with torch.no_grad(), fp32_products():
        target = text.encode_text(
            torch.from_numpy(np.asarray(tokens)).to(
                text.token_embedding.device), normalize=True)
    if args.prompt_len == "match":
        # the EOT position (the largest id), not a count of non-zero ids:
        # BPE id 0 is the token '!' and can appear inside a caption
        prompt_len = int(np.asarray(tokens)[0].argmax()) - 1   # minus SOT
        prompt_len = max(1, min(prompt_len, text.cfg.context_length - 2))
    else:
        prompt_len = int(args.prompt_len)
    out = _optimize(text, target, prompt_len, args)
    rec_ids = [int(i) for i in out["ids"]]
    return {"original": caption, "reconstructed": tokenizer.decode(rec_ids),
            "cosine_sim": float(out["sim"]), "prompt_len": prompt_len,
            "ids_orig": [int(i) for i in np.asarray(tokens)[0]],
            "ids_rec": rec_ids}


def run_image_inversion(image_paths: List[str], module, cfg, preprocess,
                        tokenizer, args) -> dict:
    """One prompt optimised against the images' CLIP features."""
    import torch

    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.preprocess import read_image

    batch = np.stack([preprocess(read_image(p)) for p in image_paths])
    with torch.no_grad(), fp32_products():
        target = module.visual.encode_image(
            torch.from_numpy(batch).to(module.logit_scale.device),
            normalize=True)
    # "match" has no caption to match: image targets take 16 slots, the
    # reference's sample config
    prompt_len = 16 if args.prompt_len == "match" else int(args.prompt_len)
    out = _optimize(module.text, target, prompt_len, args)
    rec_ids = [int(i) for i in out["ids"]]
    return {"images": list(image_paths),
            "reconstructed": tokenizer.decode(rec_ids),
            "cosine_sim": float(out["sim"]), "prompt_len": prompt_len,
            "ids_rec": rec_ids}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser("leaf_tpu_torch PEZ inversion")
    p.add_argument("--config", default=None,
                   help="JSON config; the flags given override its values")
    p.add_argument("--model", default=None)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--captions", default=None,
                   help="text file, one caption per line")
    p.add_argument("--images", nargs="+", default=None,
                   help="target image path(s); several images optimise a "
                        "single prompt across all of them")
    p.add_argument("--n-samples", type=int, default=None)
    p.add_argument("--iter", type=int, default=None)
    p.add_argument("--prompt-len", dest="prompt_len", default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--loss-weight", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the run: 'cuda' (the default) or "
                        "'cpu'")
    cli = p.parse_args(argv)

    merged = dict(DEFAULTS)
    if cli.config:
        with open(cli.config) as f:
            merged.update(json.load(f))
    for k, v in vars(cli).items():
        if v is not None:
            merged[k] = v
    args = argparse.Namespace(**merged)

    if not getattr(args, "captions", None) and \
            not getattr(args, "images", None):
        p.error("one of --captions or --images is required")

    setup_logging()
    from leaf_tpu_torch.models.factory import (create_model_and_transforms,
                                               get_tokenizer,
                                               local_checkpoint)
    model, _, preprocess = create_model_and_transforms(
        args.model, local_checkpoint(args.pretrained or None,
                                     "--pretrained", args.model),
        seed=args.seed, device=args.device)
    module = model.module
    tokenizer = get_tokenizer(args.model)

    results = []
    if getattr(args, "images", None):
        res = run_image_inversion(args.images, module, model.cfg, preprocess,
                                  tokenizer, args)
        LOG.info("image target sim=%.4f reconstructed=%r",
                 res["cosine_sim"], res["reconstructed"])
        results.append(res)
        n_items = len(args.images)
    else:
        with open(args.captions) as f:
            captions = [l.strip() for l in f if l.strip()][:args.n_samples]
        for i, caption in enumerate(captions):
            res = run_one_inversion(caption, module, tokenizer, args)
            LOG.info("[%d/%d] sim=%.4f reconstructed=%r", i + 1,
                     len(captions), res["cosine_sim"], res["reconstructed"])
            results.append(res)
        n_items = len(captions)

    payload = {"config": dict(vars(args)),
               "results": results,
               "mean_cosine_sim": float(np.mean(
                   [r["cosine_sim"] for r in results])) if results else 0.0}
    os.makedirs(args.output, exist_ok=True)
    out_path = os.path.join(
        args.output,
        f"results-{n_items}smpls-{args.iter}iters-"
        f"{args.model.replace('/', '-')}.json")
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
    LOG.info("wrote %s", out_path)
    return payload


if __name__ == "__main__":
    main()
