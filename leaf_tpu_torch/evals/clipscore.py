"""CLIPScore and FID over text-to-image results (port of
`leaf_tpu/evals/clipscore.py`):

    python -m leaf_tpu_torch.evals.clipscore --model ViT-L-14 \\
        --pretrained <checkpoint> --gen-dir gen/ --real-dir real/ \\
        --captions captions.json [--fid-features clip]

CLIPScore is max(0, 100 cos) between CLIP embeddings, over (real image,
generated image, caption) triplets; generated images that the pipeline's
NSFW filter blanked (all black) are left out, and FID (`evals.fid`) is
computed on the pairs that remain.  The model runs on `--device`
(default cuda), in fp32.

Image folders: `.npy` HWC arrays (uint8, or float in [0, 1]) need no
Pillow; PNG/JPEG files are decoded with Pillow, imported only where a
folder holds them.  Both go through the port's `image_transform`
(shortest side to the model's size, bicubic, centre crop) without
normalisation, in sorted file order, which must match the captions'.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from leaf_tpu_torch.attacks.image import _normalize_images
from leaf_tpu_torch.models.clip import l2_normalize

LOG = logging.getLogger(__name__)
IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def clip_score(image_features, text_features) -> np.ndarray:
    """Per-pair CLIPScore = max(0, 100 cos) ([N, D] x [N, D] -> [N])."""
    a = l2_normalize(torch.as_tensor(np.asarray(image_features, np.float32)))
    b = l2_normalize(torch.as_tensor(np.asarray(text_features, np.float32)))
    return np.maximum(0.0, 100.0 * (a * b).sum(-1).numpy())


def is_black_image(image: np.ndarray, threshold: float = 5 / 255) -> bool:
    """An (almost) all-black generated image: mean intensity below 5 on
    0-255, the reference's filter of NSFW-blanked images."""
    return float(np.asarray(image, np.float32).mean()) < threshold


def _keep(gen_images) -> list:
    return [i for i in range(len(gen_images))
            if not is_black_image(gen_images[i])]


def compute_clipscores(model, tokenizer, captions: Sequence[str],
                       gen_images: np.ndarray,
                       real_images: Optional[np.ndarray] = None,
                       batch_size: int = 64) -> Dict[str, object]:
    """CLIPScores of generated images against their captions (and of the
    real images against the captions and the generated ones, where real
    images are given), black images left out.  `model` is the port's
    `CLIPModel`; images are [N, H, W, 3] in [0, 1]."""
    keep = _keep(gen_images)
    n_black = len(captions) - len(keep)
    if not keep:
        return {"n": 0, "n_black_filtered": n_black,
                "clipscore_gen_caption": 0.0}

    def embed(fn, items, put):
        out = []
        with torch.inference_mode():
            for i in range(0, len(items), batch_size):
                out.append(fn(put(items[i:i + batch_size])).float().cpu()
                           .numpy())
        return np.concatenate(out, 0)

    def put_images(chunk):
        x = torch.as_tensor(np.asarray(chunk, np.float32),
                            device=model.device)
        return _normalize_images(x, model.cfg)

    def put_texts(chunk):
        return torch.as_tensor(np.asarray(tokenizer(list(chunk))),
                               device=model.device)

    text_f = embed(model.module.encode_text, [captions[i] for i in keep],
                   put_texts)
    gen_f = embed(model.module.encode_image, np.asarray(gen_images)[keep],
                  put_images)
    result: Dict[str, object] = {
        "n": len(keep), "n_black_filtered": n_black,
        "clipscore_gen_caption": float(clip_score(gen_f, text_f).mean()),
    }
    if real_images is not None:
        real_f = embed(model.module.encode_image,
                       np.asarray(real_images)[keep], put_images)
        result["clipscore_real_caption"] = float(
            clip_score(real_f, text_f).mean())
        result["clipscore_gen_real"] = float(clip_score(gen_f, real_f).mean())
    return result


def compute_clipscores_and_fid(model, tokenizer, captions: Sequence[str],
                               gen_images: np.ndarray,
                               real_images: Optional[np.ndarray] = None,
                               batch_size: int = 64,
                               fid_features: str = "clip"
                               ) -> Dict[str, object]:
    """CLIPScores over the non-black images, and FID between the real and
    the generated ones on those pairs (`fid_features`: 'clip', or
    'inception' where its weights are present, else reported as
    `fid_clip`)."""
    result = compute_clipscores(model, tokenizer, captions, gen_images,
                                real_images, batch_size)
    keep = _keep(gen_images)
    if real_images is not None and keep:
        from leaf_tpu_torch.evals.fid import (compute_fid,
                                              make_clip_feature_fn,
                                              make_inception_feature_fn)
        fn = make_inception_feature_fn() if fid_features == "inception" \
            else None
        if fn is None:
            fn = make_clip_feature_fn(model, batch_size)
            fid_features = "clip"
        result[f"fid_{fid_features}"] = compute_fid(
            np.asarray(real_images)[keep], np.asarray(gen_images)[keep], fn)
    return result


def _load_image_dir(path: str, size: Optional[int] = None) -> np.ndarray:
    """Sorted [N, H, W, 3] float32 array in [0, 1] from a folder of `.npy`
    HWC arrays and/or PNG/JPEG files, through the eval geometry
    (`image_transform` without normalisation) when `size` is given."""
    from leaf_tpu_torch.models.preprocess import image_transform
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith(IMAGE_EXTS + (".npy",)))
    tf = image_transform(size, do_normalize=False) if size else None
    imgs = []
    for f in files:
        if f.endswith(".npy"):
            im = np.load(f)
            if im.dtype != np.uint8:
                im = np.clip(np.rint(im * 255.0), 0, 255).astype(np.uint8)
        else:
            from PIL import Image
            im = Image.open(f).convert("RGB")
        imgs.append(tf(im) if tf else np.asarray(im, np.float32) / 255.0)
    return np.stack(imgs)


def main(argv=None) -> Dict[str, object]:
    """Command line: CLIPScore of generated images against captions
    (black images filtered), with real-image scores and FID where a real
    folder is given; prints the JSON and writes it to `--output`."""
    import argparse

    p = argparse.ArgumentParser("leaf_tpu_torch CLIPScore/FID")
    p.add_argument("--model", default="ViT-L-14")
    p.add_argument("--pretrained", default=None,
                   help="local HF or OpenCLIP checkpoint file or directory")
    p.add_argument("--gen-dir", required=True,
                   help="folder of generated images (sorted order "
                        "matches the captions file)")
    p.add_argument("--real-dir", default=None)
    p.add_argument("--captions", required=True, help="JSON list of captions")
    p.add_argument("--fid-features", default="clip",
                   choices=["clip", "inception"])
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--output", default=None, help="results JSON path")
    p.add_argument("--allow-random-weights", action="store_true",
                   help="score with a randomly initialised model "
                        "(tests only — the metrics are meaningless)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back to "
                        "the CPU)")
    args = p.parse_args(argv)
    if not args.pretrained and not args.allow_random_weights:
        p.error("--pretrained is required: CLIPScore from randomly "
                "initialised weights is meaningless noise "
                "(--allow-random-weights to override for tests)")

    logging.basicConfig(level=logging.INFO)
    from leaf_tpu_torch.models.factory import (create_model, get_tokenizer,
                                               local_checkpoint)
    model = create_model(args.model,
                         local_checkpoint(args.pretrained, "--pretrained",
                                          args.model),
                         device=args.device)
    tokenizer = get_tokenizer(args.model)
    with open(args.captions) as f:
        captions = json.load(f)
    size = model.cfg.vision.image_size
    gen = _load_image_dir(args.gen_dir, size)
    real = _load_image_dir(args.real_dir, size) if args.real_dir else None
    n = min(len(captions), len(gen), *([len(real)] if real is not None
                                       else []))
    out = compute_clipscores_and_fid(
        model, tokenizer, captions[:n], gen[:n],
        real[:n] if real is not None else None,
        batch_size=args.batch_size, fid_features=args.fid_features)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
