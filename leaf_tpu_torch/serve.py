"""Batch feature-extraction CLI, the serving path (port of
`leaf_tpu/serve.py`).

Embeds text and/or image inputs at a fixed batch shape (padded final
batch), optionally L2-normalized, and writes an `.npz` with the features
and the input texts/paths.  With both inputs it also writes the cosine
`scores`.  Images are image files (decoded with Pillow, imported only
for them) or `.npy` HWC uint8 arrays, which need no Pillow.

Usage:
  python -m leaf_tpu_torch.serve --model ViT-L-14-quickgelu \\
      --texts captions.txt --output feats.npz --precision bf16 --device cuda
  python -m leaf_tpu_torch.serve --model ... --images imgs_dir --output f.npz

`--device` (default cuda) is where the model runs; there is no fallback
to the CPU.  `--int8-mlp` stores the MLP weights as int8 with per-column
scales (`models.quantize`) and logs the weights' resident MiB before and
after (what the unquantized model would hold in `--precision`, and what
the quantized one holds).  `--export <dir>` also writes both encoders as
`torch.export` artifacts (`models.export`) at the batch size and with
the normalisation of the features written.

Batches are pipelined two deep: batch i+1 is enqueued on the device
before batch i's features are copied out (into pinned host memory on a
card), so that the copy and the host's next batch overlap the device's
work.
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

from leaf_tpu_torch.models.quantize import quantized_nbytes

LOG = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".webp", ".bmp", ".npy")


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


class _Readback:
    """Batch i's features on their way to the host: on a card, a copy into
    pinned memory enqueued behind the encode, and an event to wait for;
    on the CPU, the tensor itself."""

    def __init__(self, feats: torch.Tensor, n: int):
        self.n = n
        self.event = None
        if feats.is_cuda:
            self.host = torch.empty(feats.shape, dtype=feats.dtype,
                                    pin_memory=True)
            self.host.copy_(feats, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = feats

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host[:self.n].float().numpy()


def _pipelined(encode, batches) -> list:
    """Encode each (input, n) of `batches`, depth 2: batch i+1 is enqueued
    before batch i's features are read back; returns their host arrays."""
    out, pending = [], None
    for x, n in batches:
        current = _Readback(encode(x), n)
        if pending is not None:
            out.append(pending.result())
        pending = current
    if pending is not None:
        out.append(pending.result())
    return out


def _resident_nbytes(module: torch.nn.Module, dtype: torch.dtype,
                     unquantized: bool = False) -> int:
    """Bytes of `module`'s weights on the device; with `unquantized`, what
    they would take with every int8 MLP weight in `dtype` and no scales."""
    n = quantized_nbytes(module)
    if unquantized:
        for name, t in module.named_buffers():
            if name.endswith("_scale"):
                n -= t.numel() * t.element_size()
            elif t.dtype == torch.int8:
                n += t.numel() * (dtype.itemsize - 1)
    return n


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
    p.add_argument("--export", default=None,
                   help="also write the torch.export artifacts here")
    p.add_argument("--int8-mlp", action="store_true", default=False,
                   help="weight-only int8 for the transformer MLP weights "
                        "(the reference's --use-bnb-linear c_fc/c_proj "
                        "swap)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; never "
                        "falls back to the CPU)")
    args = p.parse_args(argv)
    if not args.texts and not args.images:
        p.error("need --texts and/or --images")

    from leaf_tpu_torch.models.factory import (create_model_and_transforms,
                                               get_tokenizer)

    # the tokenizer first: a config whose tokenizer is not ported refuses
    # before its model is built
    tokenizer = get_tokenizer(args.model) if args.texts else None
    model, _, preprocess = create_model_and_transforms(
        args.model, args.pretrained, precision=args.precision,
        device=args.device, int8_mlp=args.int8_mlp)
    cfg = model.cfg
    if args.int8_mlp:
        LOG.info("int8 MLP: params %0.1f → %0.1f MiB",
                 _resident_nbytes(model.module, model.dtype, True) / 2**20,
                 _resident_nbytes(model.module, model.dtype) / 2**20)
    normalize = not args.no_normalize
    bs = args.batch_size
    out = {}

    with torch.inference_mode():
        if args.texts:
            from leaf_tpu_torch.attacks.engine import bucket_tokens, can_bucket
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
            t0 = time.perf_counter()
            feats = _pipelined(
                lambda x: model.encode_text(x, normalize),
                ((_pad_to(all_toks[i:i + bs], bs),
                  len(all_toks[i:i + bs]))
                 for i in range(0, len(all_toks), bs)))
            dt = time.perf_counter() - t0
            out["text_features"] = np.concatenate(feats).astype(np.float32)
            out["texts"] = np.asarray(texts)
            LOG.info("text: %d seqs in %.2fs (%.1f/s steady-state)",
                     len(texts), dt, len(texts) / max(dt, 1e-9))

        if args.images:
            paths = _list_images(args.images)
            if not paths:
                raise FileNotFoundError(f"no images under {args.images!r}")

            def load(path):
                if path.endswith(".npy"):     # HWC uint8, no Pillow needed
                    return preprocess(np.load(path))
                from PIL import Image
                return preprocess(Image.open(path).convert("RGB"))

            def load_batch(chunk):
                return _pad_to(np.stack([load(q) for q in chunk]), bs)

            # warm-up outside the timer; every batch is then decoded and
            # encoded inside it (host decode is part of the cost, and batch
            # i+1's decode overlaps batch i's encode)
            _host(model.encode_image(load_batch(paths[:bs]), normalize))
            t0 = time.perf_counter()
            feats = _pipelined(
                lambda x: model.encode_image(x, normalize),
                ((load_batch(paths[i:i + bs]), len(paths[i:i + bs]))
                 for i in range(0, len(paths), bs)))
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

    if args.export:
        from leaf_tpu_torch.models.export import export_model
        # the dtype, batch and normalisation of the features just written
        export_model(model, args.export, batch_size=bs, normalize=normalize)
        LOG.info("exported torch.export artifacts to %s", args.export)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
