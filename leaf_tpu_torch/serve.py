"""Batch feature-extraction CLI, the serving path (port of
`leaf_tpu/serve.py`).

Embeds text and/or image inputs at a fixed batch shape (padded final
batch), optionally L2-normalized, and writes an `.npz` with the features
and the input texts/paths.  With both inputs it also writes the cosine
`scores`.

Usage:
  python -m leaf_tpu_torch.serve --model ViT-L-14-quickgelu \\
      --texts captions.txt --output feats.npz --precision bf16 --device cuda
  python -m leaf_tpu_torch.serve --model ... --images imgs_dir --output f.npz

`--device` (default cuda) is where the model runs; there is no fallback
to the CPU.  `--export` and `--int8-mlp` of the JAX CLI are not ported
yet.  Batches run one after another, each copied to the host before the
next is dispatched.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import time
from typing import List

import numpy as np
import torch

LOG = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp")


def _list_images(spec: str) -> List[str]:
    if os.path.isdir(spec):
        # case-insensitive match (IMG_0001.JPG must not be skipped)
        out = [p for p in glob.glob(os.path.join(spec, "**", "*"),
                                    recursive=True)
               if p.lower().endswith(IMAGE_EXTS)]
        return sorted(out)
    return [p for p in spec.split(",") if p]


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.broadcast_to(x[-1:], (n - x.shape[0],) + x.shape[1:])
    return np.concatenate([x, pad], axis=0)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser("leaf_tpu_torch.serve")
    p.add_argument("--model", required=True)
    p.add_argument("--pretrained", default=None,
                   help="local OpenCLIP checkpoint file or directory")
    p.add_argument("--texts", default=None,
                   help="file with one text per line")
    p.add_argument("--images", default=None,
                   help="image directory (recursive) or comma list")
    p.add_argument("--output", required=True, help=".npz output path")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--precision", default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--no-normalize", action="store_true",
                   help="skip L2 normalization of features")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; never "
                        "falls back to the CPU)")
    args = p.parse_args(argv)
    if not args.texts and not args.images:
        p.error("need --texts and/or --images")

    from leaf_tpu_torch.models.factory import (create_model_and_transforms,
                                               get_tokenizer)

    model, _, preprocess = create_model_and_transforms(
        args.model, args.pretrained, precision=args.precision,
        device=args.device)
    cfg = model.cfg
    normalize = not args.no_normalize
    bs = args.batch_size
    out = {}

    with torch.inference_mode():
        if args.texts:
            from leaf_tpu_torch.attacks.engine import bucket_tokens, can_bucket
            tokenizer = get_tokenizer(args.model)
            with open(args.texts) as f:
                texts = [line.rstrip("\n") for line in f if line.strip()]
            if not texts:
                raise ValueError(f"{args.texts!r} contains no non-blank lines")
            # tokenize everything up front and bucket once (exact under
            # causal masking + argmax pooling): one shape for every batch,
            # and short captions take the packed 16/32-token rows
            all_toks = np.asarray(tokenizer(texts))
            if can_bucket(cfg):
                all_toks = bucket_tokens(all_toks)
            # warm-up outside the timer (the first call also builds and
            # loads the kernels); every batch is then encoded inside it,
            # so the rate counts only texts encoded in the window
            _host(model.encode_text(_pad_to(all_toks[:bs], bs), normalize))
            feats = []
            t0 = time.perf_counter()
            for i in range(0, len(all_toks), bs):
                chunk = all_toks[i:i + bs]
                f = model.encode_text(_pad_to(chunk, bs), normalize)
                feats.append(_host(f)[:len(chunk)])
            dt = time.perf_counter() - t0
            out["text_features"] = np.concatenate(feats).astype(np.float32)
            out["texts"] = np.asarray(texts)
            LOG.info("text: %d seqs in %.2fs (%.1f/s steady-state)",
                     len(texts), dt, len(texts) / max(dt, 1e-9))

        if args.images:
            from PIL import Image
            paths = _list_images(args.images)
            if not paths:
                raise FileNotFoundError(f"no images under {args.images!r}")

            def load_batch(chunk):
                return _pad_to(np.stack(
                    [preprocess(Image.open(q).convert("RGB"))
                     for q in chunk]), bs)

            # warm-up outside the timer; every batch is then decoded and
            # encoded inside it (host decode is part of the cost)
            _host(model.encode_image(load_batch(paths[:bs]), normalize))
            feats = []
            t0 = time.perf_counter()
            for i in range(0, len(paths), bs):
                chunk = paths[i:i + bs]
                f = model.encode_image(load_batch(chunk), normalize)
                feats.append(_host(f)[:len(chunk)])
            dt = time.perf_counter() - t0
            out["image_features"] = np.concatenate(feats).astype(np.float32)
            out["image_paths"] = np.asarray(paths)
            LOG.info("image: %d imgs in %.2fs (%.1f/s steady-state, "
                     "incl. host decode)", len(paths), dt,
                     len(paths) / max(dt, 1e-9))

    if "text_features" in out and "image_features" in out:
        # cosine scores (features already normalized unless opted out)
        out["scores"] = out["image_features"] @ out["text_features"].T

    os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                exist_ok=True)
    np.savez(args.output, **out)
    LOG.info("wrote %s (%s)", args.output, ", ".join(sorted(out)))
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
