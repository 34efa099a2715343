"""Smoke run of `leaf_tpu_torch` on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:
  (a) the card: `nvidia-smi` name and power limit, torch's device name;
  (b) build the CUDA kernels from `leaf_tpu_torch/ops/csrc/`, timed;
  (c) each kernel against its plain PyTorch version on the card at the
      serving shapes (fp32: max abs <= 1e-4; bf16: max abs <= 2e-2), with
      CUDA-event times taken in turns (plain, kernel, kernel, plain);
  (d) `leaf_tpu_torch.serve.main` on ViT-L-14-quickgelu (seed 0, bf16):
      8192 short captions (bucket 16, 8 per 128-token row), then 4096 long
      ones (bucket 77, one per row), batch 256, so that serve's timed
      window holds 32 and 16 batches;
  (e) `encode_image` on 256 seeded 224x224 images, batch 128;
  (f) parity: a CPU fp32 copy of the same seed, plain path, against the
      card's bf16 features (cosine >= 0.99 per row) and the card's fp32
      features with TF32 off (max abs <= 1e-3);
  (g) both kernels' launch counters, zeroed just before (d), grew during
      (d) and (e) by at least layers x batches.
Any failure raises.  The line before the last is the kernels' JSON
report; the last is {"ok": true, "device": {...}}.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

MODEL = "ViT-L-14-quickgelu"
# (name, R, L, group_len, causal, D, heads, dtype name), each a batch of
# 256 captions or 128 images: text bucket 16 (8 captions per 128-token
# row), bucket 48 (2 per 96-token row, groups that straddle the kernel's
# 64-query tiles), bucket 77 (one per row), vision (257 tokens, one image
# per row)
SHAPES = [
    ("text_s16_bf16", 32, 128, 16, True, 768, 12, "bfloat16"),
    ("text_s48_bf16", 128, 96, 48, True, 768, 12, "bfloat16"),
    ("text_s77_bf16", 256, 77, 77, True, 768, 12, "bfloat16"),
    ("vision_bf16", 128, 257, 257, False, 1024, 16, "bfloat16"),
    ("text_s16_fp32", 32, 128, 16, True, 768, 12, "float32"),
    ("text_s77_fp32", 256, 77, 77, True, 768, 12, "float32"),
]
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
WORDS = ("a photo of the small large red blue green dog cat man woman child "
         "car street house tree river beach city park field table chair "
         "bird horse boat train plane sitting standing running near on "
         "under with in at old young bright dark happy").split()


def say(*parts) -> None:
    print(*parts, flush=True)


def require(ok, what: str) -> None:
    """Fail the run (a check that `python -O` keeps, unlike `assert`)."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# (a), (b)
# ---------------------------------------------------------------------------

def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    say(card)   # name and power limit, exactly as nvidia-smi prints them
    say(f"(a) torch: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return card


def phase_build():
    from leaf_tpu_torch.ops import build
    t0 = time.perf_counter()
    report = build.compile_library()
    build.library()
    dt = time.perf_counter() - t0
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"(b) ptxas: {line.strip()}")
    say(f"(b) built {os.path.relpath(build.LIBRARY)} from "
        f"{len(build.sources())} sources in {dt:.1f} s")
    return dt


# ---------------------------------------------------------------------------
# (c) kernels against their plain versions
# ---------------------------------------------------------------------------

def _time_ms(fn, n: int = 20) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _compare(kernel, plain, dtype_name: str):
    """max |kernel - plain| and (kernel ms, plain ms), timed in turns
    plain, kernel, kernel, plain after a warm-up."""
    import torch
    out_k = kernel()
    out_p = plain()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out_k).all()), "kernel output not finite")
    err = (out_k.float() - out_p.float()).abs().max().item()
    require(err <= TOLERANCE[dtype_name],
            f"max abs err {err} > {TOLERANCE[dtype_name]}")
    for fn in (kernel, plain):
        fn()
    p1, k1, k2, p2 = (_time_ms(f) for f in (plain, kernel, kernel, plain))
    return err, (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels():
    import torch
    from leaf_tpu_torch.ops import packed_attention as pa
    rows = {"packed_attention": [], "fused_attention_block": []}
    with torch.inference_mode():
        for name, R, L, S, causal, D, H, dt in SHAPES:
            dtype = getattr(torch, dt)
            rng = np.random.default_rng(0)

            def dev(a, scale=1.0, dtype=dtype):
                return torch.from_numpy(
                    (scale * a).astype(np.float32)).to("cuda", dtype)

            # q and k unit normal (softmax logits of std ~1), v at 0.5
            qkv = dev(rng.standard_normal((R, L, 3 * D))
                      * np.repeat([1.0, 1.0, 0.5], D))
            err, ms, pms = _compare(
                lambda: pa.packed_attention(qkv, H, S, causal),
                lambda: pa._reference(qkv, H, S, causal), dt)
            rows["packed_attention"].append(
                {"shape": name, "R": R, "L": L, "group_len": S,
                 "causal": causal, "D": D, "heads": H, "dtype": dt,
                 "max_abs_err": err, "ms": ms, "plain_ms": pms})
            say(f"(c) packed_attention {name}: max_abs_err {err:.3g}, "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms")

            x = dev(rng.standard_normal((R, L, D)), 0.5)
            p = {"ln_1": {"scale": dev(1 + 0.1 * rng.standard_normal(D),
                                       dtype=torch.float32),
                          "bias": dev(0.1 * rng.standard_normal(D),
                                      dtype=torch.float32)},
                 "attn": {"qkv_w": dev(rng.standard_normal((D, 3 * D)),
                                       D ** -0.5),
                          "qkv_b": dev(rng.standard_normal(3 * D), 0.1),
                          "out_w": dev(rng.standard_normal((D, D)), D ** -0.5),
                          "out_b": dev(rng.standard_normal(D), 0.1)}}
            err, ms, pms = _compare(
                lambda: pa.fused_attention_block(p, x, H, S, causal),
                lambda: pa._block_reference(p, x, H, S, causal, 1e-5), dt)
            rows["fused_attention_block"].append(
                {"shape": name, "R": R, "L": L, "group_len": S,
                 "causal": causal, "D": D, "heads": H, "dtype": dt,
                 "max_abs_err": err, "ms": ms, "plain_ms": pms})
            say(f"(c) fused_attention_block {name}: max_abs_err {err:.3g}, "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return rows


# ---------------------------------------------------------------------------
# (d), (e) the serving path
# ---------------------------------------------------------------------------

def _captions(rng, n: int, lo: int, hi: int):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


class _Rates(logging.Handler):
    """Keeps the (count, seconds, rate) arguments of serve's log lines."""

    def __init__(self):
        super().__init__()
        self.text = []

    def emit(self, record):
        if record.getMessage().startswith("text:"):
            self.text.append(record.args)


def phase_serve(workdir: str):
    from leaf_tpu_torch import serve
    from leaf_tpu_torch.attacks.engine import bucket_need
    from leaf_tpu_torch.models.factory import get_tokenizer

    rng = np.random.default_rng(0)
    sets = {"s16": _captions(rng, 8192, 3, 10),
            "s77": _captions(rng, 4096, 80, 90)}
    tok = get_tokenizer(MODEL)
    handler = _Rates()
    log = logging.getLogger("leaf_tpu_torch.serve")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    rates, batches = {}, 0
    try:
        for name, caps in sets.items():
            need = bucket_need(tok(caps))
            path = os.path.join(workdir, f"{name}.txt")
            with open(path, "w") as f:
                f.write("\n".join(caps) + "\n")
            out = serve.main(["--model", MODEL, "--texts", path, "--output",
                              os.path.join(workdir, f"{name}.npz"),
                              "--batch-size", "256", "--precision", "bf16",
                              "--device", "cuda"])
            feats = out["text_features"]
            require(feats.shape == (len(caps), 768), f"shape {feats.shape}")
            require(np.isfinite(feats).all(), "text features not finite")
            np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0,
                                       atol=1e-2)
            n, secs, rate = handler.text[-1]
            rates[name] = rate
            batches += -(-len(caps) // 256)
            say(f"(d) serve text {name}: {n} captions (bucket need {need}), "
                f"{secs:.3f} s steady state, {rate:.1f} encodes/s")
    finally:
        log.removeHandler(handler)
    return rates, batches, sets


def phase_images(model, images: np.ndarray, bs: int = 128):
    import torch
    with torch.inference_mode():
        model.encode_image(images[:bs], normalize=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = [model.encode_image(images[i:i + bs], normalize=True)
                 .float().cpu().numpy() for i in range(0, len(images), bs)]
        dt = time.perf_counter() - t0
    feats = np.concatenate(feats)
    require(feats.shape == (len(images), 768), f"shape {feats.shape}")
    require(np.isfinite(feats).all(), "image features not finite")
    rate = len(images) / dt
    say(f"(e) encode_image: {len(images)} images in {dt:.3f} s, "
        f"{rate:.1f} images/s")
    return rate, -(-len(images) // bs)


# ---------------------------------------------------------------------------
# (f) parity with a CPU fp32 copy
# ---------------------------------------------------------------------------

def _features(model, tokens, images):
    import torch
    with torch.inference_mode():
        t = model.encode_text(tokens, normalize=True).float().cpu().numpy()
        i = model.encode_image(images, normalize=True).float().cpu().numpy()
    return np.concatenate([t, i])


def phase_parity(card_bf16, sets, images):
    import torch
    from leaf_tpu_torch.attacks.engine import bucket_tokens
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer

    tok = get_tokenizer(MODEL)
    groups = [bucket_tokens(tok(sets["s16"][:32])),
              bucket_tokens(tok(sets["s77"][:32]))]
    imgs = images[:4]
    cpu = create_model(MODEL, precision="fp32", seed=0, device="cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("(f) torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    card_fp32 = create_model(MODEL, precision="fp32", seed=0, device="cuda")
    worst_cos, worst_abs = 1.0, 0.0
    for toks in groups:
        ref = _features(cpu, toks, imgs)
        low = _features(card_bf16, toks, imgs)
        full = _features(card_fp32, toks, imgs)
        cos = np.sum(ref * low, -1) / (np.linalg.norm(ref, axis=-1)
                                       * np.linalg.norm(low, axis=-1))
        worst_cos = min(worst_cos, float(cos.min()))
        worst_abs = max(worst_abs, float(np.abs(full - ref).max()))
        say(f"(f) bucket {toks.shape[1]}: {len(toks)} captions + {len(imgs)} "
            f"images, bf16 card vs fp32 CPU min cosine {cos.min():.5f}, "
            f"fp32 card vs fp32 CPU max abs {np.abs(full - ref).max():.3g}")
    require(worst_cos >= 0.99, f"bf16 cosine {worst_cos} < 0.99")
    require(worst_abs <= 1e-3, f"fp32 max abs {worst_abs} > 1e-3")
    return worst_cos, worst_abs


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.ops import packed_attention as pa

    phase_card()
    phase_build()
    rows = phase_kernels()

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        images = np.random.default_rng(1).standard_normal(
            (256, 224, 224, 3)).astype(np.float32)
        pa.packed_attention.launches = 0
        pa.fused_attention_block.launches = 0
        rates, text_batches, sets = phase_serve(workdir)
        card_bf16 = create_model(MODEL, precision="bf16", seed=0,
                                 device="cuda")
        img_rate, img_batches = phase_images(card_bf16, images)
        launches = {"packed_attention": pa.packed_attention.launches,
                    "fused_attention_block": pa.fused_attention_block.launches}
        cfg = card_bf16.cfg
        need = cfg.text.layers * text_batches + cfg.vision.layers * img_batches
        say(f"(g) launches during (d)+(e): {launches}; at least {need} "
            f"expected ({cfg.text.layers} x {text_batches} text batches + "
            f"{cfg.vision.layers} x {img_batches} image batches)")
        for name, n in launches.items():
            if n < need:
                raise AssertionError(f"{name}: {n} launches < {need}")
        phase_parity(card_bf16, sets, images)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    say(f"(d) text encodes/s: bucket 16 {rates['s16']:.1f}, "
        f"bucket 77 {rates['s77']:.1f}; (e) images/s {img_rate:.1f}")
    sources = {"packed_attention": "leaf_tpu_torch/ops/csrc/packed_attention.cu",
               "fused_attention_block": "leaf_tpu_torch/ops/csrc/fused_block.cu"}
    replaces = {"packed_attention": "leaf_tpu/ops/packed_attention.py:96",
                "fused_attention_block": "leaf_tpu/ops/packed_attention.py:208"}
    report = []
    for name, by_shape in rows.items():
        main_shape = by_shape[0]     # text bucket 16, bf16
        report.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "shape": main_shape["shape"], "by_shape": by_shape})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
