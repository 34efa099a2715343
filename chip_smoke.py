"""Smoke run of `leaf_tpu_torch` on one CUDA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines:
  (a) the card: `nvidia-smi` name and power limit, torch's device name;
  (b) build the CUDA kernels from `leaf_tpu_torch/ops/csrc/`, timed, and
      the native C++ tokenizer from `leaf_tpu_torch/tokenizer/native/` with
      the host compiler;
  (c) each kernel against its plain PyTorch version on the card at the
      shapes the serving, training and eval paths give it, the fused step's
      half batches, the zero-shot classifier's text shapes, the eval's
      fp32 vision shape and the text attacks' scoring chunks among them (fp32: max abs <= 1e-4; bf16: max abs <= 2e-2, or
      two bf16 rounding steps, 2^-6 of the value, where that is more; for
      the GEMM's rows with a residual, 2^-6 of the value's and the
      residual's sizes together), with CUDA-event times taken in turns
      (plain, kernel, library, kernel, plain), the time of the one PyTorch
      call that computes the same function where there is one
      (`scaled_dot_product_attention`; used nowhere in the package), and
      the least time the card could take for the same bytes and
      operations (these times include each wrapper's host time; the fused
      block and its parts are also timed on the device alone, 20 calls
      replayed from one CUDA graph); then, untimed, both bf16 kernels over a sweep of ragged
      shapes (groups of 13 to 257 tokens, heads of 8 to 128, sequences of
      1 to 257) and the gradients of one shape of each (kernel forward,
      recompute backward) against the plain version's; and the fused
      block's parts alone, bf16: the GEMM + bias kernel at the block's qkv
      and out-projection shapes (text buckets 16 and 77, vision, the fused
      and the unfused train step's; the out-projections also with their
      residual) and at three ragged
      shapes in every tile width, with `torch.addmm` as its library call
      and its operations bound, and in fp32 at the eval's vision qkv and
      out-projection shapes; the LayerNorm op at the bf16 shapes and two
      fp32 ones (text bucket 77, the eval's vision shape), with
      `F.layer_norm` and its bytes bound, and its gradients;
  (d) `leaf_tpu_torch.serve.main` on ViT-L-14-quickgelu (seed 0, bf16):
      4096 short captions (bucket 16, 8 per 128-token row), then 2048 long
      ones (bucket 77, one per row), batch 256, so that serve's timed
      window holds 16 and 8 batches;
  (e) `encode_image` on 256 seeded 224x224 images, batch 128;
  (f) parity: a CPU fp32 copy of the same seed, plain path, against the
      card's bf16 features (cosine >= 0.99 per row) and the card's fp32
      features with TF32 off (max abs <= 1e-3);
  (g) both packed kernels' launch counters, zeroed just before (d), grew
      during (d) and (e) by at least layers x batches, and the LayerNorm
      op's by (layers + 1) x text batches + (layers + 2) x image batches
      (`ln_2` of every block, `ln_final`; `ln_pre`, `ln_post`);
  (h) `flash_attention`, the opt-in op no tower calls, driven directly:
      `mha_with_flash` on a ViT-L vision batch, once per vision layer,
      its counter zeroed just before, and held against the plain version
      on a slice of that batch;
  (i) train-step parity at ViT-tiny-test, fp32, TF32 off: gradients and
      two train steps on the card (kernels forward, recompute backward)
      against the same on the CPU (plain versions); then the fused
      attack+train step: on the card it picks the sentences of the unfused
      attack + train step (free and constrained), and two fused steps are
      within 1e-4 of the CPU's (same sentences, loss, parameters);
  (j) the trainer on ViT-L-14-quickgelu (bf16 compute on fp32 master
      weights, batch 128, rho 50, k 1), each cell with the kernels' counters
      zeroed just before and held, just after, to the count its encodes
      imply: `leaf_tpu_torch.train.driver.main` with the fused step on the
      synthetic caption, 8 steps, unconstrained; the same with
      `--constrain`, saved, then resumed by a second `main` call with
      `--resume latest --epochs 2` (8 more steps), its `model_epoch_2`
      export read back by `interop.load_pretrained` with equal features,
      `times_False.csv` one row per step (every `main` call keeps the
      recipe's sizes but not its schedule: `--lr-scheduler const` after 2
      warm-up steps where the recipe has a cosine, because the cells below
      go on from the first call's state past its 8 steps, where a cosine
      over 8 steps has run out; the schedule is one multiplication on the
      host and no part of a step's time); the unfused loop on the same
      caption, 4 steps; then seeded captions of 3 to 58 words whose batches
      need buckets 16, 32, 48 and 64: the fused loop unconstrained (two
      passes: anchors missed, then hit) and constrained, the unfused loop,
      4 steps each.  Every fused cell prints, per step, the host's
      preparation seconds, the seconds it waited for the device, step
      seconds, samples/s and candidates/s, and how many of its first
      best-probe readbacks returned while the second half's phase 1 was
      still running; the tokenizer's counters show that the candidate grids
      went through the native library;
  (k) the recipe with its evals: first `zero_shot_eval` at ViT-tiny-test,
      fp32, TF32 off, on the card and on the CPU from the same weights (the
      full 1000-class, 80-template classifier, a folder of 16 seeded
      arrays, both synthetic text sets): the same clean top-1/top-5 and
      text accuracies, and the Charmer classification attack picks the
      same sentences; then `train.driver.main` with the flags of
      `scripts/train_leaf_vitl.sh` on local files at ViT-L-14-quickgelu's
      full width and depth (bf16 on fp32 master weights, batch 128, rho 50,
      k 1, --constrain, the cosine schedule after 2 warm-up steps where the
      recipe warms up for 1400): 3 tar shards of 1,000 unique seeded
      captions of 3-58 words, 8 steps; `--imagenet-val` on 128 seeded
      224x224 `.npy` arrays in 8 class folders; `--val-text-classification
      synthetic --n_val_text 64`.  The kernels' counters are zeroed just
      before each of its two evals (epoch 0 and 1) and held, just after, to
      the encodes it makes (classifier, Charmer grids, templated scoring;
      clean, 10 PGD steps and adversarial image encodes in fp32, anchor
      encodes); it prints each eval part's seconds and both rows' seven
      eval columns (finite, in [0, 1]).  Last, the fused and the unfused
      loop over the same tar set, one epoch each, no evals;
  (l) the text attacks and the standalone evals: first, at ViT-tiny-test,
      fp32, TF32 off, the card against the CPU from the same weights: the
      batched Charmer (free and constrained), bruteforce and one
      `--use_charmer` attack pick the same sentences, and TextFARE,
      zero-shot text and retrieval give the same metrics; then, at
      ViT-L-14-quickgelu's full width and depth (random weights, seed 0),
      through each command line's `main` on the card: `evals.textfare` on
      the synthetic sentences (charmer and leaf at 32 sentences, rho 50,
      bf16; charmer in fp32 at 8; bruteforce at 4), `evals.zero_shot_text`
      with `scripts/dress_rehearsal.sh`'s flags (32 sentences, rho 20, image
      anchors, bf16), `evals.retrieval` on 32 seeded 256 x 256 `.npy`
      images with 5 captions each (rho 10, bf16, untargeted and `--target
      0`), and `train.driver.main --use_charmer` (batch 128, rho 50, k 1):
      2 steps on "Dummy caption", 1 step with `--constrain` on (k)'s tar
      set.  Each part prints its seconds, its candidates per second, its
      chunks per scoring call and its peak device memory, with the
      kernels' counters held to 12 / 13 launches per text encode and 24 /
      26 per image encode;
  (m) FARE and the ImageNet robust eval: first, at ViT-tiny-test, fp32,
      TF32 off, the card against the CPU from the same weights: 2 FARE
      steps with PGD from the same starts and 2 with APGD give the same
      losses and parameters (1e-4), the APGD cascade and Square the same
      fooled masks and adversarial images (1e-4); `train.fare_driver.main`
      on the card for 3 steps and again with `--resume latest --steps 5`
      (Adam's moments and step carried, the milestones there, no fallback
      left); then at ViT-H-14's full width and depth (random weights, seed
      0; D 1280, 16 heads of width 80, GELU): `fare_driver.main` with
      `scripts/train_fare_vith.sh`'s flags (bf16 on fp32 master weights,
      batch 128, PGD-10 L-inf at eps 2/255, AdamW at lr 1e-5, wd 1e-4;
      3 steps after 1 warm-up step where the recipe has 10,000 after 700)
      on 256 seeded 256 x 256 `.npy` arrays in 8 classes, with block remat,
      then 1 step with `--no-remat`: per step the device's seconds split
      into anchor, attack and update, images/s, the loader's wait and the
      launches, held to 1 forward-only and 11 differentiated encodes (a
      differentiated block launches twice under remat); the peak device
      memory; each checkpoint's size and its seconds; finite positive
      losses, the frozen tower unchanged, the trained one moved; last
      `evals.imagenet_robust.main` (fp32, TF32 off) on 32 seeded `.npy`
      images, each put in the class folder (of 1,000) that the model's
      clean prediction names, by a first pass with the same weights and
      classifier that also runs Square alone on them (20 iterations), since
      with random weights APGD may leave Square nothing to attack; the
      eval itself runs 10 APGD iterations, 1 target, Square with 20:
      seconds per part (classifier, clean, APGD, Square), peak memory, the
      launches held to its 100 text and its image encodes, clean and
      robust top-1 in [0, 1], robust <= clean.  (c) has rows at ViT-H's
      shapes: the block, `packed_attention` and the LayerNorm at [128,
      257, 1280] bf16 and [32, 257, 1280] fp32, and the block's GEMMs;
  (n) contrastive CLIP training: first, at ViT-tiny-test, fp32, TF32 off,
      the card against the CPU from the same weights: two plain steps and
      two feature-cache steps (`--accum-freq 2`) give the same losses and
      parameters (1e-4), `evaluate_contrastive` and the LEAF driver's
      `--val-data` the same metrics; then at ViT-B-32's full width and
      depth (random weights, seed 0; vision 12 x 768, 50 tokens; text
      12 x 512, 8 heads; bf16 on fp32 master weights, batch 256, lr 5e-4,
      wd 0.2, `--local-loss`, `--workers 4`): the plain step with its
      batch already on the card (CUDA events), then
      `train.contrastive_driver.main` on 2,048 seeded 256 x 256 `.npy`
      image-caption pairs in 8 tar shards: 8 plain steps (cosine after 2
      warm-up steps) with `--val-data` over one more shard before and
      after, saved; `--resume latest` for 2 more; 4 steps each with
      `--siglip`, `--accum-freq 2`, `--distill-model ViT-B-32` and
      `--lock-image` (the vision tower unchanged bit for bit).  Per step
      its span on the device (CUDA events), the loader's wait, the loop's
      samples/s, its peak device memory and the launches, held to 1 pass
      of both towers a plain step, 4 with the feature cache, 2 with the
      teacher and 1 a val batch; the val metrics finite, recalls in
      [0, 1].  (c) has rows at ViT-B-32's shapes: both kernels and the
      LayerNorm at [256, 77, 512] causal and [256, 50, 768] bf16, and the
      block's GEMMs;
  (o) the benchmark suite and PEZ: first, at ViT-tiny-test, fp32, TF32
      off, the card against the CPU from the same seeded weights:
      `benchmark.cli eval` gives the same JSON metrics for zero-shot
      classification clean and with `--attack apgd` (5 iterations),
      retrieval, caption selection and the linear probe (its loss within
      1e-4), and 20 PEZ steps choose the same ids at every step; then at
      ViT-L-14-quickgelu's full width and depth (random weights, seed 0)
      through each command line's `main` on the card: `cli eval` (fp32,
      batch 64) on a CIFAR-10 pickle layout of 1,024 seeded images, an
      imagenet1k WordNet-id folder (8 classes, 64 `.npy` images, 80
      templates), the CIFAR set in bf16, APGD (10 iterations, CE + 3
      targets) on 32 CIFAR images, a Karpathy retrieval JSON (64 images x
      5 captions), a SugarCrepe JSON (64 records), the linear probe on
      8-class folders (256 / 64 images, 100 epochs) and with `--fewshot-k
      8`; `build` and `reformat` over the JSONs; `evals.pez_driver.main`
      on 2 seeded captions (300 iterations; the default is 3,000) and on 2
      target images (16 slots, 100 iterations), `pez_metrics.main`, and
      20 PEZ steps under `torch.profiler`.  Each part prints its seconds by
      part (model build, waits for the host's images, encodes), images/s,
      peak memory and metrics (finite, in [0, 1], robust <= clean), with
      its encodes and the kernels' launches held (PEZ: one text encode a
      step).  (c) has rows at the shapes: both kernels and the LayerNorm at
      [64, 257, 1024] fp32 and bf16 and at [1, 77, 768] fp32 causal, and
      the block's fp32 GEMMs at M = 64 x 257;
  (p) CLIPScore/FID, the text-to-image harness, HF checkpoints, int8, export,
      the profiler and the run-management flags: first, at ViT-tiny-test,
      fp32, TF32 off, the card against the CPU from the same seeded weights:
      CLIPScore and CLIP-FID, `generate_images` with tiny injected components
      (DDIM and PLMS), int8 MLP features and the HF round trip within 1e-5;
      the export traced on the card holds the custom ops
      (`torch.ops.leaf_tpu_torch.*`, one block per layer) and gives the eager
      features; and the wrapper time of the custom-op route against the
      direct call at (c)'s small shapes; then at ViT-L-14-quickgelu's full
      width and depth (random weights): `convert.main` OpenCLIP -> HF ->
      OpenCLIP with `--verify` (1e-4) on the card, exact, seconds and GB a
      file, and `push_to_hf_hub.main --local-dir-only`; `clipscore.main` on
      256 generated (16 black, reported filtered) and 256 real 224 x 224
      `.npy` images with CLIP-FID, images/s, then from the HF directory under
      the GELU name (its QuickGELU adopted: the same scores);
      `text_to_image.main` stage 1 on 64 captions (rho 10, k 2, fp32) and the
      dual-encoder mode on 8 (the second tower from seed 1), captions/s;
      `serve.main --int8-mlp` (bf16, 2,048 captions at bucket 16 with 128
      `.npy` images, 512 at bucket 77), MiB before and after, encodes/s,
      cosine >= 0.99 against the unquantized runs, one of which writes
      `--export`: the artifacts run on the card (launches held) and equal the
      eager features; `utils.profiler.main` on the card within 1% of the CPU
      count; `train.driver.main` for 8 steps of (j)'s cell with
      `--profile-dir`, `--remote-sync`, `--copy-codebase` and
      `--matmul-precision highest`: the trace, the mirrored checkpoints and
      the code snapshot are there.  Each encoding part holds the kernels'
      launches to its encodes.
Any failure raises.  The line before the last is the kernels' JSON
report (each kernel at its main-path shape; the line before it has the
rows of every shape); the last is {"ok": true, "device": {...}}.  Without CUDA, or
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
DEVICE = "cuda"
# (name, R, L, group_len, causal, D, heads, dtype name).  Serving, each a
# batch of 256 captions or 128 images: text bucket 16 (8 captions per
# 128-token row), bucket 48 (2 per 96-token row, groups that straddle the
# kernel's 64-query tiles), bucket 77 (one per row), vision (257 tokens,
# one image per row).  Training, batch 128 x rho 50: the fused step
# (`train.driver.main`) scores half batches, 64 x 50 = 3200 candidates,
# at bucket 16 in 400 rows and at bucket 64 (2 per row) in 1600, and
# encodes 64 captions for a half's anchors and train forward (8 rows at
# bucket 16); the unfused loop scores 6400 candidates at once (800 rows)
FUSED_MAIN_SHAPE = "fused_s16_bf16"
SHAPES = [
    ("text_s16_bf16", 32, 128, 16, True, 768, 12, "bfloat16"),
    (FUSED_MAIN_SHAPE, 400, 128, 16, True, 768, 12, "bfloat16"),
    ("fused_half_s16_bf16", 8, 128, 16, True, 768, 12, "bfloat16"),
    ("fused_s64_bf16", 1600, 128, 64, True, 768, 12, "bfloat16"),
    ("train_s16_bf16", 800, 128, 16, True, 768, 12, "bfloat16"),
    ("text_s48_bf16", 128, 96, 48, True, 768, 12, "bfloat16"),
    ("text_s77_bf16", 256, 77, 77, True, 768, 12, "bfloat16"),
    ("vision_bf16", 128, 257, 257, False, 1024, 16, "bfloat16"),
    ("text_s16_fp32", 32, 128, 16, True, 768, 12, "float32"),
    ("text_s77_fp32", 256, 77, 77, True, 768, 12, "float32"),
    # the in-training eval (k): the zero-shot classifier encodes 10 classes
    # x 80 templates = 800 prompts a call, 84 of its 100 calls at bucket 16
    # (8 a row) and 16 at bucket 32 (4 a row); images are encoded and
    # attacked with PGD in fp32, 128 a batch
    ("classifier_s16_bf16", 100, 128, 16, True, 768, 12, "bfloat16"),
    ("classifier_s32_bf16", 200, 128, 32, True, 768, 12, "bfloat16"),
    ("eval_vision_fp32", 128, 257, 257, False, 1024, 16, "float32"),
    # the text attacks (l): a scoring call's candidates go in chunks of at
    # most `engine.chunk_rows` sequences, 43,688 at bucket 16 in bf16 (8 a
    # row: 5,461 rows; the batched Charmer's candidate grids, --use_charmer
    # and the bf16 evals), 10,920 at bucket 64 (2 a row: 5,460 rows; the
    # long captions of --use_charmer --constrain) and 21,840 at bucket 16
    # in fp32 (2,730 rows; the evals' default precision)
    ("charmer_s16_bf16", 5461, 128, 16, True, 768, 12, "bfloat16"),
    ("charmer_s64_bf16", 5460, 128, 64, True, 768, 12, "bfloat16"),
    ("charmer_s16_fp32", 2730, 128, 16, True, 768, 12, "float32"),
    # FARE (m) at ViT-H-14: D = 1280, 16 heads of width 80, 257 tokens; the
    # trainer's bf16 batch of 128 images and the robust eval's fp32 batch
    # of 32
    ("fare_vith_bf16", 128, 257, 257, False, 1280, 16, "bfloat16"),
    ("robust_vith_fp32", 32, 257, 257, False, 1280, 16, "float32"),
    # contrastive training (n) at ViT-B-32, batch 256: the text tower at
    # D 512, 8 heads of 64, one 77-token caption per row; the vision tower
    # at D 768, 12 heads, 50 tokens (7 x 7 patches of 32 + the class token)
    ("contrastive_text_s77_bf16", 256, 77, 77, True, 512, 8, "bfloat16"),
    ("contrastive_vision_bf16", 256, 50, 50, False, 768, 12, "bfloat16"),
    # the benchmark command line (o) encodes images 64 a batch (its
    # default), in fp32 (its default) and bf16; PEZ runs one 77-token prompt
    # through the text tower in fp32, forward and the input's gradient
    ("bench_vision_fp32", 64, 257, 257, False, 1024, 16, "float32"),
    ("bench_vision_bf16", 64, 257, 257, False, 1024, 16, "bfloat16"),
    ("pez_text_s77_fp32", 1, 77, 77, True, 768, 12, "float32"),
]
# (name, M, K, N) of the fused block's two GEMMs on the main path; the
# out-projections run again with their residual
GEMM_SHAPES = [("s16 qkv", 32 * 128, 768, 2304), ("s16 out", 32 * 128, 768, 768),
               ("s77 qkv", 256 * 77, 768, 2304), ("s77 out", 256 * 77, 768, 768),
               ("vision qkv", 128 * 257, 1024, 3072),
               ("vision out", 128 * 257, 1024, 1024),
               ("fused s16 qkv", 400 * 128, 768, 2304),
               ("fused s16 out", 400 * 128, 768, 768),
               ("fused half qkv", 8 * 128, 768, 2304),
               ("fused half out", 8 * 128, 768, 768),
               ("fused s64 qkv", 1600 * 128, 768, 2304),
               ("fused s64 out", 1600 * 128, 768, 768),
               ("train qkv", 800 * 128, 768, 2304),
               ("train out", 800 * 128, 768, 768),
               ("charmer s16 qkv", 5461 * 128, 768, 2304),
               ("charmer s16 out", 5461 * 128, 768, 768),
               ("fare vith qkv", 128 * 257, 1280, 3840),
               ("fare vith out", 128 * 257, 1280, 1280),
               ("b32 text qkv", 256 * 77, 512, 1536),
               ("b32 text out", 256 * 77, 512, 512),
               ("b32 vision qkv", 256 * 50, 768, 2304),
               ("b32 vision out", 256 * 50, 768, 768)]
# M = 3 rows of 77 tokens; N and K multiples of 8 and of no tile (64 k, 128
# to 256 columns), one of them narrower than a single TMA box
# the eval's fp32 vision GEMMs: the block's qkv and out projections
EVAL_FP32_GEMM_SHAPES = [("eval vision qkv fp32", 128 * 257, 1024, 3072),
                         ("eval vision out fp32", 128 * 257, 1024, 1024),
                         ("robust vith qkv fp32", 32 * 257, 1280, 3840),
                         ("robust vith out fp32", 32 * 257, 1280, 1280),
                         ("bench vision qkv fp32", 64 * 257, 1024, 3072),
                         ("bench vision out fp32", 64 * 257, 1024, 1024)]
RAGGED_GEMM_SHAPES = [("ragged 231x72x200", 231, 72, 200),
                      ("ragged 231x776x1096", 231, 776, 1096),
                      ("ragged 231x8x40", 231, 8, 40)]
GEMM_TILES = (256, 192, 128)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
REL_TOLERANCE = {"float32": 0.0, "bfloat16": 2.0 ** -6}
# flash_attention on [B, H, S, d]: (name, B, H, S, d, causal): the ViT-L
# vision shape, the text tower's at buckets 77 and 16, and one with S a
# multiple of no tile and heads of 80
FLASH_SHAPES = [
    ("vision", 128, 16, 257, 64, False),
    ("text_s77", 256, 12, 77, 64, True),
    ("text_s16", 64, 12, 16, 64, True),
    ("s130_d80_causal", 8, 16, 130, 80, True),
    ("s130_d80", 8, 16, 130, 80, False),
]
# published peaks of one H100 SXM (dense, at a 700 W limit): device memory
# rate, tensor-core bf16 rate, fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
WORDS = ("a photo of the small large red blue green dog cat man woman child "
         "car street house tree river beach city park field table chair "
         "bird horse boat train plane sitting standing running near on "
         "under with in at old young bright dark happy").split()


def say(*parts) -> None:
    print(*parts, flush=True)


# wall seconds of each phase of `main`, printed before the kernels' report
PHASE_SECONDS = {}


def _timed(name: str, fn, *args):
    """`fn(*args)`, its wall seconds kept under `name`."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)


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
    from leaf_tpu_torch.tokenizer import native_binding
    t0 = time.perf_counter()
    native_binding.compile_library()
    native_binding.library()
    say(f"(b) built {os.path.relpath(native_binding.LIBRARY)} from "
        f"{os.path.relpath(native_binding.SOURCE)} with "
        f"{native_binding.COMPILER} in {time.perf_counter() - t0:.1f} s")
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


def _graph_ms(fn, n: int = 20, replays: int = 5) -> float:
    """Device time of one call: `n` calls captured in one CUDA graph and
    replayed, so that the wrapper's host time, which exceeds a small
    kernel's, is not in it."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    return _time_ms(graph.replay, replays) / n


def _close(out, ref, what: str, dtype_name: str = "bfloat16",
           residual=None) -> float:
    """Hold a result to the plain version's, within the dtype's tolerance;
    returns the largest difference.  `residual` is the tensor that both
    sides added last to a value they had rounded before."""
    import torch
    torch.cuda.synchronize()
    require(out.shape == ref.shape and out.dtype == ref.dtype,
            f"{what}: {tuple(out.shape)} {out.dtype} against "
            f"{tuple(ref.shape)} {ref.dtype}")
    require(bool(torch.isfinite(out).all()), f"{what}: not finite")
    diff = (out.float() - ref.float()).abs()
    # bf16 keeps 8 bits: from |value| = 2 on, two rounding steps are
    # 0.03125, more than the absolute tolerance (the fused block rounds
    # qkv, the attention output and the sum, and among the 79 million
    # outputs of a training batch a few land two steps apart), so large
    # values are held to two steps (2^-6 of the value) instead
    size = ref.float().abs()
    if residual is not None:
        # the rounded value y = ref - residual may differ by one step of
        # its own (|y| / 128 at most, and |y| <= |ref| + |residual|), and
        # where the residual cancels it that is more than two steps of the
        # sum: of 79 million outputs a few have |y| > 4 and |ref| < 2
        size = size + residual.float().abs()
    allowed = torch.clamp(size * REL_TOLERANCE[dtype_name],
                          min=TOLERANCE[dtype_name])
    require(bool((diff <= allowed).all()),
            f"{what}: max abs err {diff.max().item()} > "
            f"{TOLERANCE[dtype_name]} (and more than "
            f"{REL_TOLERANCE[dtype_name]} of the value)")
    return diff.max().item()


def _compare(kernel, plain, dtype_name: str, library=None, residual=None):
    """max |kernel - plain| and (kernel ms, plain ms, library ms), timed
    in turns plain, kernel, library, kernel, plain after a warm-up, each
    call through its Python wrapper.  `library` is one PyTorch call that
    computes the same function; it is timed here and used nowhere in the
    package."""
    out_p = plain()
    err = _close(kernel(), out_p, "kernel", dtype_name, residual)
    lib_ms = None
    if library is not None:
        lib_err = (library().float() - out_p.float()).abs().max().item()
        require(lib_err <= 5e-2,
                f"the library call computes another function: {lib_err}")
    for fn in (kernel, plain):
        fn()
    p1, k1 = _time_ms(plain), _time_ms(kernel)
    if library is not None:
        lib_ms = _time_ms(library)
    k2, p2 = _time_ms(kernel), _time_ms(plain)
    return err, (k1 + k2) / 2, (p1 + p2) / 2, lib_ms


def _bound(n_bytes: float, flops: float, dtype_name: str):
    """The least time (ms) the card could take: the bytes the function
    must move (inputs read once, outputs written once) over the memory
    rate, or its operations over the peak rate for the inputs' type,
    whichever is larger, and which of the two it is."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _visible_pairs(L: int, group_len: int, causal: bool) -> int:
    """(query, key) pairs of one row of L tokens that attention computes."""
    pairs = 0
    for g0 in range(0, L, group_len):
        n = min(group_len, L - g0)
        pairs += n * (n + 1) // 2 if causal else n * n
    return pairs


def _schedule(L: int, group_len: int, causal: bool, allow_exact: bool = True):
    """The bf16 kernel's schedule for a row, from the built library, after
    holding the package's Python mirror of it equal."""
    from leaf_tpu_torch.ops import packed_attention as pa
    args = (L, group_len, causal, allow_exact)
    built, mirror = pa.kernel_schedule(*args), pa.tile_schedule(*args)
    require(built == mirror, f"tile_schedule{args} is not the library's "
            f"schedule: {mirror[0]} against {built[0]}")
    return built


def _visible_share(L: int, group_len: int, causal: bool,
                   allow_exact: bool = True) -> float:
    """Share of the logits the bf16 kernel computes (16 queries x the key
    steps of every tile, by the library's own schedule) that attention
    needs.  Derived from the shape, not measured: it goes into the phase's
    printed line and not into the kernels' report."""
    from leaf_tpu_torch.ops.packed_attention import TILE
    _, tiles = _schedule(L, group_len, causal, allow_exact)
    computed = sum(TILE * (hi - lo)
                   for _, _, spans in tiles for lo, hi in spans)
    return _visible_pairs(L, group_len, causal) / computed


def _row(name, shape, dt, err, ms, pms, lib_ms, n_bytes, flops,
         visible_share=None, **extra):
    bound_ms, bound_by = _bound(n_bytes, flops, dt)
    device = ("" if "device_ms" not in extra else
              f" ({extra['device_ms']:.4f} on the device, from a CUDA graph)")
    say(f"(c) {name} {shape} {dt}: max_abs_err {err:.3g}, kernel {ms:.4f} ms"
        f"{device}, plain {pms:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{bound_ms:.4f} ms by {bound_by}"
        + ("" if visible_share is None else
           f", {visible_share:.2f} of the computed logits visible"))
    return {"shape": shape, "dtype": dt, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": n_bytes, "flops": flops, **extra}


def phase_kernels():
    import torch
    from torch.nn import functional as F
    from leaf_tpu_torch.ops import flash_attention as fa
    from leaf_tpu_torch.ops import packed_attention as pa
    rows = {"packed_attention": [], "fused_attention_block": [],
            "flash_attention": []}
    t0 = time.perf_counter()
    with torch.inference_mode():
        for name, R, L, S, causal, D, H, dt in SHAPES:
            dtype = getattr(torch, dt)
            esize = 2 if dt == "bfloat16" else 4
            # drawn on the card: the largest rows hold billions of values,
            # which a host generator takes minutes to draw
            g = torch.Generator(device="cuda").manual_seed(0)

            def dev(*shape, scale=1.0, shift=0.0, dtype=dtype):
                return (torch.randn(*shape, generator=g, device="cuda")
                        * scale + shift).to(dtype)

            # q and k unit normal (softmax logits of std ~1), v at 0.5
            qkv = torch.randn(R, L, 3 * D, generator=g, device="cuda")
            qkv[..., 2 * D:] *= 0.5
            qkv = qkv.to(dtype)
            mask = pa.block_mask(L, S, causal, "cuda")

            def sdpa(qkv=qkv, mask=mask):
                # the library's attention on the same fused qkv, with the
                # block-diagonal pattern as a boolean mask
                q, k, v = (t.reshape(R, L, H, D // H).transpose(1, 2)
                           for t in qkv.split(D, dim=-1))
                out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                return out.transpose(1, 2).reshape(R, L, D)

            attn_flops = 4.0 * (D // H) * _visible_pairs(L, S, causal) * H * R
            err, ms, pms, lib = _compare(
                lambda: pa.packed_attention(qkv, H, S, causal),
                lambda: pa._reference(qkv, H, S, causal), dt, sdpa)
            rows["packed_attention"].append(_row(
                "packed_attention", name, dt, err, ms, pms, lib,
                4.0 * R * L * D * esize, attn_flops, R=R, L=L, group_len=S,
                causal=causal, D=D, heads=H,
                visible_share=(_visible_share(L, S, causal)
                               if dt == "bfloat16" else None)))

            x = dev(R, L, D, scale=0.5)
            p = {"ln_1": {"scale": dev(D, scale=0.1, shift=1.0,
                                       dtype=torch.float32),
                          "bias": dev(D, scale=0.1, dtype=torch.float32)},
                 "attn": {"qkv_w": dev(D, 3 * D, scale=D ** -0.5),
                          "qkv_b": dev(3 * D, scale=0.1),
                          "out_w": dev(D, D, scale=D ** -0.5),
                          "out_b": dev(D, scale=0.1)}}
            err, ms, pms, lib = _compare(
                lambda: pa.fused_attention_block(p, x, H, S, causal),
                lambda: pa._block_reference(p, x, H, S, causal, 1e-5), dt)
            rows["fused_attention_block"].append(_row(
                "fused_attention_block", name, dt, err, ms, pms, lib,
                (2.0 * R * L * D + 4 * D * D + 4 * D) * esize + 2 * D * 4,
                2.0 * R * L * D * 4 * D + attn_flops, R=R, L=L, group_len=S,
                causal=causal, D=D, heads=H, device_ms=_graph_ms(
                    lambda: pa.fused_attention_block(p, x, H, S, causal))))

        PHASE_SECONDS["c attention rows"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        for name, B, H, S, d, causal in FLASH_SHAPES:
            for dt in ("bfloat16", "float32"):
                dtype = getattr(torch, dt)
                esize = 2 if dt == "bfloat16" else 4
                rng = np.random.default_rng(0)
                q, k, v = (torch.from_numpy(
                    (s * rng.standard_normal((B, H, S, d))).astype(np.float32)
                ).to("cuda", dtype) for s in (1.0, 1.0, 0.5))
                err, ms, pms, lib = _compare(
                    lambda: fa.flash_attention(q, k, v, causal=causal),
                    lambda: fa._reference(q, k, v, d ** -0.5, causal), dt,
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal))
                rows["flash_attention"].append(_row(
                    "flash_attention", name, dt, err, ms, pms, lib,
                    4.0 * B * H * S * d * esize,
                    4.0 * d * _visible_pairs(S, S, causal) * B * H,
                    B=B, heads=H, S=S, d=d, causal=causal,
                    visible_share=(_visible_share(S, S, causal, False)
                                   if dt == "bfloat16" else None)))

        # the fused-qkv wrapper, at the vision shape
        B, H, S, d = FLASH_SHAPES[0][1:5]
        qkv = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, S, 3 * H * d)).astype(np.float32)).to("cuda", torch.bfloat16)
        out = fa.mha_with_flash(qkv, H)
        ref = pa._reference(qkv, H, S, False)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        require(out.shape == (B, S, H * d) and err <= TOLERANCE["bfloat16"],
                f"mha_with_flash: shape {tuple(out.shape)}, max abs err {err}")
        say(f"(c) mha_with_flash vision bfloat16 against the packed plain "
            f"version: max_abs_err {err:.3g}")
        PHASE_SECONDS["c flash rows"] = round(time.perf_counter() - t0, 1)
        parts = _timed("c parts", phase_parts)
    _timed("c sweep", phase_sweep)
    return rows, parts


def phase_parts():
    """The fused block's GEMM and LayerNorm kernels alone (called inside
    `inference_mode`); the LayerNorm op's gradients are in the sweep."""
    import torch
    from torch.nn import functional as F
    from leaf_tpu_torch.ops import packed_attention as pa
    parts = {"gemm_bias": [], "layer_norm": []}
    g = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device="cuda", generator=g) * scale).to(dtype)

    say("(c) torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32} (the plain GEMM is fp32)")
    for name, M, K, N in GEMM_SHAPES + RAGGED_GEMM_SHAPES:
        a, w, b = normal(M, K), normal(K, N, scale=K ** -0.5), normal(N)
        ragged = (name, M, K, N) in RAGGED_GEMM_SHAPES
        residuals = [None]
        if ragged or name.endswith("out"):
            residuals.append(normal(M, N))
        for res in residuals:
            if ragged:   # every tile width, untimed
                want = pa._gemm_bias_reference(a, w, b, res)
                for tile_n in GEMM_TILES:
                    _close(pa._launch_gemm_bias(a, w, b, res, tile_n), want,
                           f"gemm_bias {name} tile {tile_n}", residual=res)
            err, ms, pms, lib = _compare(
                lambda: pa._launch_gemm_bias(a, w, b, res),
                lambda: pa._gemm_bias_reference(a, w, b, res), "bfloat16",
                None if res is not None else lambda: torch.addmm(b, a, w),
                residual=res)
            n_bytes = 2.0 * (M * K + K * N + N + M * N * (1 if res is None else 2))
            parts["gemm_bias"].append(_row(
                "gemm_bias", name + ("" if res is None else " + residual"),
                "bfloat16", err, ms, pms, lib, n_bytes, 2.0 * M * N * K,
                M=M, K=K, N=N, residual=res is not None,
                tflops=2.0 * M * N * K / ms / 1e9, device_ms=_graph_ms(
                    lambda: pa._launch_gemm_bias(a, w, b, res))))
    say(f"(c) gemm_bias: the ragged shapes also agree in every tile width "
        f"{GEMM_TILES}")
    for name, M, K, N in EVAL_FP32_GEMM_SHAPES:
        # fp32 runs on scalar FMAs; the library call is torch.addmm, TF32 off
        a = normal(M, K, dtype=torch.float32)
        w = normal(K, N, scale=K ** -0.5, dtype=torch.float32)
        b = normal(N, dtype=torch.float32)
        err, ms, pms, lib = _compare(
            lambda: pa._launch_gemm_bias(a, w, b),
            lambda: pa._gemm_bias_reference(a, w, b), "float32",
            lambda: torch.addmm(b, a, w))
        parts["gemm_bias"].append(_row(
            "gemm_bias", name, "float32", err, ms, pms, lib,
            4.0 * (M * K + K * N + N + M * N), 2.0 * M * N * K, M=M, K=K, N=N,
            residual=False, tflops=2.0 * M * N * K / ms / 1e9,
            device_ms=_graph_ms(lambda: pa._launch_gemm_bias(a, w, b))))

    for name, R, L, _, _, D, _, dt in SHAPES:
        if name == "text_s16_fp32":   # fp32 is held at bucket 77 alone
            continue
        dtype = getattr(torch, dt)
        M = R * L
        x = normal(M, D, scale=2.0, dtype=dtype) + 0.5
        # fp32 parameters that bf16 holds exactly, so that the library
        # call, which wants them in x's dtype, computes the same function
        scale = (1 + normal(D, scale=0.1)).float()
        bias = normal(D, scale=0.1).float()
        scale_t, bias_t = scale.to(dtype), bias.to(dtype)
        err, ms, pms, lib = _compare(
            lambda: pa.layer_norm(x, scale, bias, 1e-5),
            lambda: pa._layer_norm_reference(x, scale, bias, 1e-5), dt,
            lambda: F.layer_norm(x, (D,), scale_t, bias_t, 1e-5))
        parts["layer_norm"].append(_row(
            "layer_norm", name, dt, err, ms, pms, lib,
            2.0 * M * D * x.element_size() + 8 * D, 8.0 * M * D, M=M, D=D,
            device_ms=_graph_ms(lambda: pa.layer_norm(x, scale, bias, 1e-5))))
    return parts


# (group_len, groups per row, causal): groups that straddle the 16-query
# tiles, every text bucket, the vision tower's 257 = 16 x 16 + 1 tokens, and
# rows too long to stage whole (the ring of 64-key stages)
PACKED_SWEEP = [(13, 3, False), (13, 3, True), (16, 8, True), (24, 5, True),
                (32, 4, True), (48, 2, True), (64, 2, True), (77, 1, True),
                (80, 1, False), (257, 1, False), (200, 3, False),
                (401, 1, True)]
FLASH_SWEEP_S = (1, 15, 16, 17, 63, 65, 130, 257, 600)
FLASH_SWEEP_D = (8, 40, 64, 80, 128)


def phase_sweep():
    """Correctness only, bf16: ragged shapes through both tensor-core
    kernels, then the gradients of one shape of each."""
    import torch
    from leaf_tpu_torch.ops import flash_attention as fa
    from leaf_tpu_torch.ops import packed_attention as pa

    def normal(rng, *shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to("cuda", torch.bfloat16)

    rng = np.random.default_rng(6)
    worst, cases = 0.0, 0
    with torch.inference_mode():
        for S, G, causal in PACKED_SWEEP:
            for hd in (64, 80):
                R, H = 3, 3
                _schedule(G * S, S, causal)
                qkv = normal(rng, R, G * S, 3 * H * hd)
                worst = max(worst, _close(
                    pa.packed_attention(qkv, H, S, causal),
                    pa._reference(qkv, H, S, causal),
                    f"packed_attention S={S} G={G} causal={causal} hd={hd}"))
                cases += 1
        # ViT-H-14's rows: 16 heads of width 80 over 257 tokens, and one
        # token either side
        for L in (256, 257, 258):
            _schedule(L, L, False)
            qkv = normal(rng, 2, L, 3 * 16 * 80)
            worst = max(worst, _close(
                pa.packed_attention(qkv, 16, L, False),
                pa._reference(qkv, 16, L, False),
                f"packed_attention L={L} 16 x 80"))
            cases += 1
        say(f"(c) sweep packed_attention bf16: {cases} shapes "
            f"(group_len, groups, causal) in {PACKED_SWEEP} x head widths "
            f"(64, 80) and 16 heads of 80 at 256-258 tokens, max_abs_err "
            f"{worst:.3g}")
        worst, cases = 0.0, 0
        for S in FLASH_SWEEP_S:
            for d in FLASH_SWEEP_D:
                for causal in (False, True):
                    _schedule(S, S, causal, False)
                    q, k, v = (normal(rng, 2, 3, S, d) for _ in range(3))
                    worst = max(worst, _close(
                        fa.flash_attention(q, k, v, causal=causal),
                        fa._reference(q, k, v, d ** -0.5, causal),
                        f"flash_attention S={S} d={d} causal={causal}"))
                    cases += 1
        # head views of a token-major qkv, read in place
        qkv = normal(rng, 3, 130, 3 * 4 * 40)
        _close(fa.mha_with_flash(qkv, 4, True),
               pa._reference(qkv, 4, 130, True), "mha_with_flash S=130 d=40")
        say(f"(c) sweep flash_attention bf16: {cases} shapes, S in "
            f"{FLASH_SWEEP_S} x d in {FLASH_SWEEP_D} x causal or not, and "
            f"mha_with_flash on strided views, max_abs_err {worst:.3g}")
        say("(c) schedule: the Python mirror (tile_schedule) equals the "
            "library's make_plan and passes at every timed and swept shape")

    # gradients: kernel forward with the recompute backward, against autograd
    # through the plain version; held to 2e-2 of the largest gradient.  Both
    # backwards recompute through the plain version, so the two sides differ
    # only by the forward's output, which the comparisons above already
    # hold: this cannot fail where they pass on values.  What it guards is
    # the way through autograd: the saved (strided) inputs, the kernel's
    # output as the head of a graph, and one launch per forward.
    def grads(fn, *leaves):
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        fn(*ts).float().sin().sum().backward()
        return [t.grad.float() for t in ts]

    qkv = normal(rng, 4, 96, 3 * 12 * 64)
    q, k, v = (normal(rng, 2, 4, 130, 64) for _ in range(3))
    x = normal(rng, 4, 77, 768)
    ln_scale, ln_bias = (normal(rng, 768).float() * 0.1 + i for i in (1, 0))
    for name, kernel, plain, leaves in (
            ("layer_norm (4, 77, 768)",
             lambda *t: pa.layer_norm(*t, 1e-5),
             lambda *t: pa._layer_norm_reference(*t, 1e-5),
             (x, ln_scale, ln_bias)),
            ("packed_attention (4, 96, 2304) S=48 causal",
             lambda t: pa.packed_attention(t, 12, 48, True),
             lambda t: pa._reference(t, 12, 48, True), (qkv,)),
            ("flash_attention (2, 4, 130, 64) causal",
             lambda *t: fa.flash_attention(*t, causal=True),
             lambda *t: fa._reference(*t, 64 ** -0.5, True), (q, k, v))):
        def launches():
            return (pa.packed_attention.launches + fa.flash_attention.launches
                    + pa.layer_norm.launches)

        before = launches()
        got, want = grads(kernel, *leaves), grads(plain, *leaves)
        torch.cuda.synchronize()
        require(launches() == before + 1,
                f"{name}: the forward did not launch the kernel")
        scale = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        require(all(bool(torch.isfinite(g).all()) for g in got)
                and err <= 2e-2 * scale,
                f"{name}: gradients differ by {err} (largest {scale})")
        say(f"(c) gradient {name} bf16: max abs diff {err:.3g} (largest "
            f"gradient {scale:.3g})")


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
    sets = {"s16": _captions(rng, 4096, 3, 10),
            "s77": _captions(rng, 2048, 80, 90)}
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
# (h) flash attention, driven directly
# ---------------------------------------------------------------------------

def phase_flash(layers: int):
    """The opt-in op as a user would call it: `mha_with_flash` on the
    fused qkv of a ViT-L vision batch, once per vision layer."""
    import torch
    from leaf_tpu_torch.ops import flash_attention as fa
    from leaf_tpu_torch.ops import packed_attention as pa
    _, B, H, S, d, _ = FLASH_SHAPES[0]
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, 3 * H * d)).astype(np.float32)).to("cuda", torch.bfloat16)
    fa.flash_attention.launches = 0
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(layers):
            out = fa.mha_with_flash(qkv, H)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        ref = pa._reference(qkv[:4], H, S, False)
    require(out.shape == (B, S, H * d) and out.dtype == torch.bfloat16,
            f"mha_with_flash gives {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out).all()), "mha_with_flash: not finite")
    err = (out[:4].float() - ref.float()).abs().max().item()
    require(err <= TOLERANCE["bfloat16"], f"mha_with_flash: max abs err {err}")
    require(launches == layers, f"flash_attention: {launches} launches, "
            f"{layers} calls")
    say(f"(h) mha_with_flash: {layers} calls on [{B}, {S}, {3 * H * d}] bf16 "
        f"in {dt * 1e3:.2f} ms (head split and merge included), max_abs_err "
        f"{err:.3g} on 4 images, {launches} launches")
    return launches


# ---------------------------------------------------------------------------
# (i) train-step parity, card against CPU
# ---------------------------------------------------------------------------

def _tiny_tokens(rng, B: int, S: int) -> np.ndarray:
    toks = np.zeros((B, S), np.int64)
    for row in toks:
        e = int(rng.integers(2, S))
        row[0] = 49406
        row[1:e] = rng.integers(1, 49400, size=e - 1)
        row[e] = 49407
    return toks


def phase_train_parity():
    import copy
    import torch
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.train import optim, schedules, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    clean, adv1, adv2 = (_tiny_tokens(rng, 32, 16) for _ in range(3))
    runs = {}
    for device in ("cpu", "cuda"):
        text = create_model("ViT-tiny-test", precision="fp32", seed=0,
                            device=device).module.text
        frozen = copy.deepcopy(text).requires_grad_(False)
        put = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
        anchors = step.make_anchor_encode()(frozen, put(clean))
        step.textfare_loss(text, put(adv1), anchors).backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in text.named_parameters()}
        text.zero_grad(set_to_none=True)
        # lr 1e-4: Adam's g / (|g| + 1e-6) turns the rounding noise of the
        # near-zero gradients into differences of up to lr per step
        opt = optim.make_optimizer(text.named_parameters(),
                                   schedules.const_lr(1e-4, 0, 2),
                                   weight_decay=1e-4, grad_clip_norm=1.0)
        state = step.TrainState.create(text, opt)
        train = step.make_train_step()
        metrics = []
        for adv in (adv1, adv2):
            state, m = train(state, put(adv), anchors)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[device] = (metrics, grads,
                        {n: p.detach().cpu() for n, p in
                         text.named_parameters()})
    (cm, cg, cp), (gm, gg, gp) = runs["cpu"], runs["cuda"]
    for (cl, cn), (gl, gn) in zip(cm, gm):
        require(abs(gl - cl) <= 1e-4 * abs(cl), f"loss {gl} vs CPU {cl}")
        require(abs(gn - cn) <= 1e-3 * abs(cn), f"grad norm {gn} vs CPU {cn}")
    scale = max(float(g.abs().max()) for g in cg.values())
    grad_err = max(float((gg[n] - cg[n]).abs().max()) for n in cg)
    param_err = max(float((gp[n] - cp[n]).abs().max()) for n in cp)
    require(grad_err <= 1e-4 * scale,
            f"gradients differ by {grad_err} (largest gradient {scale})")
    require(param_err <= 1e-4, f"parameters differ by {param_err}")
    say(f"(i) train-step parity, ViT-tiny-test fp32, TF32 off: losses card "
        f"{[m[0] for m in gm]} vs CPU {[m[0] for m in cm]}, gradient max abs "
        f"diff {grad_err:.3g} (largest gradient {scale:.3g}), parameters "
        f"after 2 steps max abs diff {param_err:.3g}")
    return grad_err, param_err


def phase_fused_parity():
    """The fused attack+train step at ViT-tiny-test, fp32, TF32 off: on
    the card it picks the unfused path's sentences (free and constrained),
    and two fused steps on the card are within 1e-4 of the CPU's."""
    import copy
    import torch
    from leaf_tpu_torch.attacks.constraint import WordConstraint
    from leaf_tpu_torch.attacks.engine import CandidateScorer, bucket_tokens
    from leaf_tpu_torch.attacks.text import attack_text_leaf
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import fused, optim, schedules, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(8)
    batches = [_captions(rng, 32, 3, 10) for _ in range(2)]
    tok = get_tokenizer("ViT-tiny-test")
    rho = 8

    def fresh(device):
        model = create_model("ViT-tiny-test", precision="fp32", seed=0,
                             device=device)
        text = model.module.text
        frozen = copy.deepcopy(text).requires_grad_(False)
        opt = optim.make_optimizer(text.named_parameters(),
                                   schedules.const_lr(1e-4, 0, 2),
                                   weight_decay=1e-4)
        return model.cfg, step.TrainState.create(text, opt), frozen

    # fused against unfused, on the card
    for constrained in (False, True):
        wc = WordConstraint() if constrained else None
        cfg, state, frozen = fresh("cuda")
        clean = torch.from_numpy(bucket_tokens(tok(batches[0]))).cuda()
        anchors = step.make_anchor_encode()(frozen, clean)
        _, want = attack_text_leaf(CandidateScorer(cfg, "cuda"), state.text,
                                   tok, batches[0], anchors, n=rho,
                                   constraint=wc,
                                   rng=np.random.default_rng(9))
        adv = torch.from_numpy(bucket_tokens(tok(want))).cuda()
        state, m_unfused = step.make_train_step()(state, adv, anchors)
        for pipeline in (False, True):
            cfg, state_f, frozen_f = fresh("cuda")
            fs = fused.FusedLeafStep(cfg, tok, rho, constraint=wc,
                                     pipeline=pipeline, device="cuda")
            state_f, info = fs(state_f, frozen_f, batches[0],
                               np.random.default_rng(9))
            got = fs.adv_sentences(batches[0], info)
            require(got == want, f"fused (pipeline={pipeline}, constrained="
                    f"{constrained}) and unfused pick different sentences")
            lf, lu = float(info["metrics"]["loss"]), float(m_unfused["loss"])
            require(abs(lf - lu) <= 1e-4 * abs(lu),
                    f"fused loss {lf} vs unfused {lu}")
        changed = sum(a != b for a, b in zip(want, batches[0]))
        say(f"(i) fused = unfused on the card, ViT-tiny-test fp32, "
            f"{'constrained' if constrained else 'unconstrained'}: the same "
            f"32 sentences ({changed} changed), pipelined and not, loss "
            f"{lf:.6f} vs {lu:.6f}")

    # two fused steps (pipelined, constrained), card against CPU
    runs = {}
    for device in ("cpu", "cuda"):
        cfg, state, frozen = fresh(device)
        fs = fused.FusedLeafStep(cfg, tok, rho, constraint=WordConstraint(),
                                 device=device)
        rng_d = np.random.default_rng(10)
        advs, losses = [], []
        for texts in batches:
            state, info = fs(state, frozen, texts, rng_d)
            advs.append(fs.adv_sentences(texts, info))
            losses.append(float(info["metrics"]["loss"]))
        runs[device] = (advs, losses, {n: p.detach().cpu() for n, p in
                                       state.text.named_parameters()})
    (ca, cl, cp), (ga, gl, gp) = runs["cpu"], runs["cuda"]
    require(ga == ca, "the fused step picks other sentences on the card "
            "than on the CPU")
    for c, g in zip(cl, gl):
        require(abs(g - c) <= 1e-4 * abs(c), f"fused loss {g} vs CPU {c}")
    param_err = max(float((gp[n] - cp[n]).abs().max()) for n in cp)
    require(param_err <= 1e-4, f"fused parameters differ by {param_err}")
    say(f"(i) fused step parity, card vs CPU: the same sentences in 2 steps, "
        f"losses card {gl} vs CPU {cl}, parameters max abs diff "
        f"{param_err:.3g}")


# ---------------------------------------------------------------------------
# (j) the trainer
# ---------------------------------------------------------------------------

TRAIN_FLAGS = ["--model", MODEL, "--precision", "bf16", "--dataset-type",
               "synthetic", "--batch-size", "128", "--rho", "50", "--k_adv",
               "1", "--lr", "1e-5", "--wd", "1e-4", "--warmup", "2",
               "--lr-scheduler", "const", "--zeroshot-frequency", "0",
               "--epochs", "1", "--train-num-samples", "1024",
               "--log-every-n-steps", "1", "--delete-previous-checkpoint",
               "--device", "cuda"]
BATCH, RHO, K = 128, 50, 1


class _Steps(logging.Handler):
    """Keeps the arguments of the loop's per-step log lines: (epoch, seen,
    samples, percent, data s, batch s, samples/s, attack s, loss, mean)."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if str(record.msg).startswith("Train Epoch"):
            self.steps.append(record.args)


class _CaptionBatches:
    """Batches of seeded captions, one range of lengths per batch.  The
    loop comes back for the next batch between two steps: `marks` keeps
    what `seconds` (running totals of host and device or wait seconds)
    held then."""

    def __init__(self, batches, seconds):
        self.batches = batches
        self.seconds = seconds
        self.marks = []

    def __iter__(self):
        for texts in self.batches:
            self.marks.append(dict(self.seconds))
            yield None, texts


def _step_times(tag, steps):
    losses = [a[8] for a in steps]
    require(all(np.isfinite(v) and v > 0 for v in losses),
            f"{tag}: losses {losses}")
    step_s = float(np.mean([a[5] for a in steps]))
    say(f"(j) {tag}: {len(steps)} steps, losses "
        f"{[round(v, 4) for v in losses]}")
    return step_s, {"steps": len(steps), "step_s": step_s,
                    "samples_per_s": BATCH / step_s,
                    "candidates_per_s": 2 * K * BATCH * RHO / step_s}


def _report_unfused(tag, steps, seconds):
    """Print rates and the host/device split of the unfused loop's `steps`
    (log-line tuples) whose attacks took `seconds` in all; every mean is
    over all steps."""
    step_s, out = _step_times(tag, steps)
    n = len(steps)
    attack_s = float(np.mean([a[7] for a in steps]))
    host_s, dev_s = seconds["host"] / n, seconds["device"] / n
    say(f"(j) {tag}: {step_s:.3f} s per step (the first {steps[0][5]:.3f}), "
        f"{out['samples_per_s']:.1f} samples/s, "
        f"{out['candidates_per_s']:.0f} candidates/s; attack "
        f"{attack_s:.3f} s per step = host (edit + tokenize) {host_s:.3f} s "
        f"+ device (scoring, waited for) {dev_s:.3f} s; rest of the step "
        f"(anchors, tokenizing, train step) {step_s - attack_s:.3f} s; host "
        f"share of a step {host_s / step_s:.2f}")
    return dict(out, attack_s=attack_s, host_s=host_s, device_s=dev_s)


def _report_fused(tag, steps, before, fused_step):
    """Print rates of the fused loop's `steps` and, from the fused step's
    running totals since `before`, the host's preparation and waiting
    seconds per step and where the first readbacks returned."""
    step_s, out = _step_times(tag, steps)
    n = len(steps)
    host_s = (fused_step.seconds["host"] - before["host"]) / n
    wait_s = (fused_step.seconds["wait"] - before["wait"]) / n
    early = fused_step.readbacks["early"] - before["early"]
    late = fused_step.readbacks["late"] - before["late"]
    require(early + late == n and early > 0,
            f"{tag}: of the first readbacks of {n} pipelined steps, {early} "
            f"returned before the second half's phase 1 had finished and "
            f"{late} after")
    steady = float(np.mean([a[5] for a in steps[1:]])) if n > 1 else step_s
    say(f"(j) {tag}: {step_s:.3f} s per step (the first {steps[0][5]:.3f}, "
        f"the others {steady:.3f}), {out['samples_per_s']:.1f} samples/s, "
        f"{out['candidates_per_s']:.0f} candidates/s; host preparation "
        f"(native grids, masks, draws) {host_s:.3f} s per step, host waited "
        f"for best-probe readbacks {wait_s:.3f} s, the rest (enqueuing, "
        f"copies, the loop) {step_s - host_s - wait_s:.3f} s; host "
        f"preparation share of a step {host_s / step_s:.2f}; the first "
        f"half's readback returned before the second half's phase 1 had "
        f"finished in {early} of {n} steps")
    return dict(out, host_s=host_s, wait_s=wait_s, steady_step_s=steady,
                readbacks_early=early, readbacks_late=late)


def _fused_marks(fused_step):
    return {**fused_step.seconds, **fused_step.readbacks}


class _Counters:
    """The three ops' launch counters, zeroed and read around a cell."""

    NAMES = ("packed_attention", "fused_attention_block", "layer_norm")

    def __init__(self):
        from leaf_tpu_torch.ops import packed_attention as pa
        self.ops = {name: getattr(pa, name) for name in self.NAMES}
        self.total = dict.fromkeys(self.NAMES, 0)

    def zero(self):
        for op in self.ops.values():
            op.launches = 0

    def hold(self, tag: str, encodes: int, layers: int, why: str):
        """Read the counters, hold them to `encodes` text encodes (a fused
        block and its attention kernel per layer, `ln_2` per layer plus
        `ln_final` for the LayerNorm op) and add them to the totals."""
        import torch
        torch.cuda.synchronize()
        want = {"packed_attention": layers * encodes,
                "fused_attention_block": layers * encodes,
                "layer_norm": (layers + 1) * encodes}
        got = {name: op.launches for name, op in self.ops.items()}
        say(f"(j) launches, {tag}: {got}; {encodes} encodes expected ({why}) "
            f"= {want}")
        for name in self.NAMES:
            require(got[name] == want[name],
                    f"{tag}: {name} {got[name]} launches, {want[name]} "
                    "expected")
            self.total[name] += got[name]


def _anchor_misses(batches, cache: set) -> int:
    """How many half-batches of `batches` the pipelined fused step encodes
    anchors for: a half misses unless all its captions are cached; its
    captions are cached at once (before the second half is looked up)."""
    misses = 0
    for texts in batches:
        h = len(texts) // 2
        for half in (texts[:h], texts[h:]):
            if not all(t in cache for t in half):
                misses += 1
            cache.update(half)
    return misses


def _csv_rows(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _check_run_files(out, epochs, n_steps):
    """results.csv rows for epochs 0..N, one attack time per step."""
    rows = _csv_rows(os.path.join(out["out_dir"], "results.csv"))
    require([r["epoch"] for r in rows] == [str(e) for e in epochs]
            and all(float(r["train_loss"]) > 0 for r in rows
                    if r["epoch"] != "0"), f"results.csv: {rows}")
    with open(os.path.join(out["out_dir"], "times_False.csv")) as f:
        times = f.read().split()
    require(times[0] == "0" and len(times) == 1 + n_steps
            and all(float(t) > 0 for t in times[1:]),
            f"times_False.csv: {len(times) - 1} rows for {n_steps} steps: "
            f"{times}")
    return [float(t) for t in times[1:]]


def phase_train(workdir: str):
    import torch
    from leaf_tpu_torch.attacks import edits
    from leaf_tpu_torch.attacks.constraint import WordConstraint
    from leaf_tpu_torch.attacks.engine import CandidateScorer, bucket_need
    from leaf_tpu_torch.data.common import DataInfo
    from leaf_tpu_torch.models import interop
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import driver, fused, loop, params, step

    n_steps = 8
    handler = _Steps()
    log = logging.getLogger("leaf_tpu_torch.train.loop")
    log.addHandler(handler)
    counters = _Counters()
    tok = get_tokenizer(MODEL)
    results = {}
    try:
        # ---- driver.main, fused, unconstrained, the synthetic caption
        tok_before = dict(tok.counts)
        counters.zero()
        out = driver.main(TRAIN_FLAGS + ["--logs", workdir, "--name", "free"])
        cfg, layers = out["cfg"], out["cfg"].text.layers
        fs = out["fused_step"]
        # per step: 2 probe + 2 candidate scoring encodes and the train
        # forward's 2 half encodes (its backward recomputes through the
        # plain version and launches nothing); the caption is the same in
        # every row, so only the first step's first half encodes anchors
        counters.hold("train.driver fused, 'Dummy caption'", 6 * n_steps + 1,
                      layers, f"{n_steps} steps x (2 probe + 2 candidate + 2 "
                      "train-forward half encodes) + 1 anchor encode, the "
                      "cache hit ever after")
        results["fused_s16"] = _report_fused(
            "train.driver fused, caption 'Dummy caption' (bucket 16)",
            handler.steps, dict.fromkeys(_fused_marks(fs), 0), fs)
        require(len(handler.steps) == n_steps, f"{len(handler.steps)} steps")
        times = _check_run_files(out, (0, 1), n_steps)
        say(f"(j) times_False.csv: {n_steps} rows, attack seconds "
            f"{[round(t, 3) for t in times]}")
        grids = tok.counts["native_texts"] - tok_before["native_texts"]
        python_texts = tok.counts["python_texts"] - tok_before["python_texts"]
        say(f"(j) tokenizer counters over the run: {grids} texts through the "
            f"native library, {python_texts} through the Python tokenizer")
        require(grids >= n_steps * 2 * BATCH * RHO and python_texts == 0,
                f"native {grids}, python {python_texts}")

        # the frozen copy still holds the seed's weights bit for bit; the
        # trainable tower has moved, in fp32
        fresh = create_model(MODEL, precision="bf16", seed=0, device="cuda",
                             master_weights=True).module.text.state_dict()
        frozen = out["frozen_text"].state_dict()
        trained = out["state"].text.state_dict()
        require(all(torch.equal(frozen[n], fresh[n]) for n in fresh),
                "the frozen anchor tower changed")
        moved = max(float((trained[n] - fresh[n]).abs().max()) for n in fresh)
        require(moved > 0 and all(t.dtype == torch.float32
                                  for t in trained.values()),
                f"the trainable tower moved by {moved}")
        say(f"(j) frozen tower unchanged bit for bit; trainable tower (fp32 "
            f"master weights) moved by at most {moved:.3g}")
        del fresh
        shutil.rmtree(os.path.join(out["out_dir"], "checkpoints"))

        # ---- the unfused loop on the same caption, state and towers
        args = params.parse_args(TRAIN_FLAGS)
        state, frozen_text = out["state"], out["frozen_text"]
        scorer = CandidateScorer(cfg, "cuda")
        unfused_steps = 4

        def run_loop(batches, epoch, seed, fused_step=None, constraint=None):
            """One epoch of the loop over caption batches; returns the
            unfused attack's host/device seconds and the loader."""
            handler.steps.clear()
            seconds = {"host": 0.0, "device": 0.0}
            watched = fused_step.seconds if fused_step is not None else seconds
            loader = _CaptionBatches(batches, watched)
            data = {"train": DataInfo(loader, num_batches=len(batches),
                                      num_samples=BATCH * len(batches))}
            counters.zero()
            loop.train_one_epoch_text_only(
                state, frozen_text, scorer, step.make_anchor_encode(),
                step.make_train_step(), tok, edits.DEFAULT_VOCAB, data, epoch,
                args, constraint=constraint, rng=np.random.default_rng(seed),
                seconds=seconds, fused_step=fused_step)
            torch.cuda.synchronize()
            loader.marks.append(dict(watched))
            return seconds, loader

        seconds, _ = run_loop([["Dummy caption"] * BATCH] * unfused_steps,
                              1, 5)
        # the frozen tower's anchor encode, 2 scoring encodes, the train
        # forward, each in one chunk
        counters.hold("unfused loop, 'Dummy caption'", 4 * unfused_steps,
                      layers, f"{unfused_steps} steps x (anchor + 2 scoring + "
                      "train forward)")
        results["unfused_s16"] = _report_unfused(
            "unfused loop, caption 'Dummy caption' (bucket 16)",
            handler.steps, seconds)
        del out

        # ---- driver.main, fused, --constrain; saved; resumed
        marks = None
        for leg, extra in enumerate((["--epochs", "1"],
                                     ["--epochs", "2", "--resume", "latest"])):
            handler.steps.clear()
            counters.zero()
            out = driver.main(TRAIN_FLAGS + ["--constrain", "--logs", workdir,
                                             "--name", "constrained"] + extra)
            fs = out["fused_step"]
            counters.hold(f"train.driver fused --constrain, leg {leg + 1}",
                          6 * n_steps + 1, layers,
                          f"{n_steps} steps x 6 half encodes + 1 anchor encode")
            results[f"constrained_s16_leg{leg + 1}"] = _report_fused(
                "train.driver fused --constrain, caption 'Dummy caption', "
                + ("epoch 1" if leg == 0 else "--resume latest, epoch 2"),
                handler.steps, dict.fromkeys(_fused_marks(fs), 0), fs)
            require(out["state"].step == n_steps * (leg + 1),
                    f"step {out['state'].step} after leg {leg + 1}")
            if leg == 0:
                _check_run_files(out, (0, 1), n_steps)
                ckpts = os.path.join(out["out_dir"], "checkpoints")
                require(sorted(os.listdir(ckpts)) == [
                    "epoch_1", "frozen", "model_epoch_1"],
                    f"checkpoints after epoch 1 with "
                    f"--delete-previous-checkpoint: {os.listdir(ckpts)}")
                marks = {n: p.detach().clone() for n, p in
                         out["state"].text.named_parameters()}
                del out
                torch.cuda.empty_cache()
        _check_run_files(out, (0, 1, 2), n_steps)
        moved = max(float((p.detach() - marks[n]).abs().max())
                    for n, p in out["state"].text.named_parameters())
        adam_steps = {int(s["step"]) for s in out["state"].optimizer.adamw
                      .state_dict()["state"].values()}
        require(moved > 0 and adam_steps == {2 * n_steps},
                f"the resumed leg moved the tower by {moved}; AdamW step "
                f"counts {adam_steps}")
        with open(os.path.join(out["out_dir"], "out.log")) as f:
            require("resuming from" in f.read(), "no resume in out.log")
        # the export, read back by the port's own loader
        export = os.path.join(ckpts, "model_epoch_2")
        require(sorted(os.listdir(export)) == [
            "open_clip_config.json", "open_clip_model.safetensors"],
            f"export: {os.listdir(export)}")
        size = os.path.getsize(
            os.path.join(export, "open_clip_model.safetensors"))
        t0 = time.perf_counter()
        loaded = create_model(MODEL, export, precision="bf16", device="cuda")
        dt = time.perf_counter() - t0
        toks = torch.from_numpy(tok(["a photo of a dog", "Dummy caption"])
                                [:, :16].astype(np.int64)).cuda()
        with torch.inference_mode():
            want = out["state"].text.encode_text(toks).float()
            got = loaded.module.text.encode_text(toks).float()
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()) and err == 0.0,
                f"features of the export read back differ by {err}")
        say(f"(j) --resume latest continued at step {n_steps} to "
            f"{out['state'].step}; export {size / 1e9:.2f} GB written and "
            f"read back by interop.load_pretrained in {dt:.1f} s, text "
            f"features equal (max abs diff {err})")
        del loaded, out, marks
        shutil.rmtree(ckpts)
        torch.cuda.empty_cache()

        # ---- captions of 3-58 words (about one token a word): batches
        # whose longest caption needs bucket 16, 32, 48, 64
        rng = np.random.default_rng(4)
        ranges = [(3, 8), (18, 26), (34, 42), (50, 58)]
        batches = [_captions(rng, BATCH, lo, hi) for lo, hi in ranges]
        needs = [bucket_need(tok(b)) for b in batches]
        say(f"(j) caption batches of {ranges} words need context {needs}")
        require([min(b for b in (16, 32, 48, 64, 77) if n <= b)
                 for n in needs] == [16, 32, 48, 64], f"buckets of {needs}")

        def fused_cell(tag, fs, epoch, cache):
            before = _fused_marks(fs)
            misses = _anchor_misses(batches, cache)
            _, loader = run_loop(batches, epoch, 5, fused_step=fs,
                                 constraint=fs.constraint)
            counters.hold(tag, 6 * len(batches) + misses, layers,
                          f"{len(batches)} steps x 6 half encodes + {misses} "
                          "anchor encodes of halves that missed the cache")
            for i, (bucket, a) in enumerate(zip((16, 32, 48, 64),
                                                handler.steps)):
                host, wait = (loader.marks[i + 1][key] - loader.marks[i][key]
                              for key in ("host", "wait"))
                say(f"(j) {tag}, bucket {bucket}: step {a[5]:.3f} s, host "
                    f"preparation {host:.3f} s, waited {wait:.3f} s, loss "
                    f"{a[8]:.4f}")
            return _report_fused(tag + " (buckets 16-64)", handler.steps,
                                 before, fs)

        kw = dict(cfg=cfg, tokenizer=tok, rho=RHO, k=K, device="cuda")
        fs_free = fused.FusedLeafStep(**kw)
        cache = set()
        results["fused_long_miss"] = fused_cell(
            "fused loop, captions of 3-58 words, anchors missed", fs_free, 2,
            cache)
        results["fused_long_hit"] = fused_cell(
            "fused loop, captions of 3-58 words, anchors cached", fs_free, 3,
            cache)
        fs_con = fused.FusedLeafStep(constraint=WordConstraint(), **kw)
        results["constrained_long"] = fused_cell(
            "fused loop --constrain, captions of 3-58 words, anchors missed",
            fs_con, 4, set())

        seconds, loader = run_loop(batches, 5, 5)
        counters.hold("unfused loop, captions of 3-58 words",
                      4 * len(batches), layers,
                      f"{len(batches)} steps x (anchor + 2 scoring + train "
                      "forward)")
        for i, (bucket, a) in enumerate(zip((16, 32, 48, 64), handler.steps)):
            host, dev = (loader.marks[i + 1][key] - loader.marks[i][key]
                         for key in ("host", "device"))
            say(f"(j) unfused, bucket {bucket}: step {a[5]:.3f} s, attack "
                f"{a[7]:.3f} s = host {host:.3f} s + device {dev:.3f} s, loss "
                f"{a[8]:.4f}")
        results["unfused_long"] = _report_unfused(
            "unfused loop, captions of 3-58 words (buckets 16-64)",
            handler.steps, seconds)
        python_texts = tok.counts["python_texts"] - tok_before["python_texts"]
        say(f"(j) tokenizer counters over (j): "
            f"{tok.counts['native_texts'] - tok_before['native_texts']} texts "
            f"native, {python_texts} Python")
        # (the unfused loop tokenizes whole adversarial strings: one with
        # an inserted '&' is outside the native contract and goes through
        # the Python tokenizer, by the JAX package's rule)
    finally:
        log.removeHandler(handler)
    return counters.total, results


# ---------------------------------------------------------------------------
# (k) the recipe with its evals
# ---------------------------------------------------------------------------

# the recipe (`scripts/train_leaf_vitl.sh`) on local files: 3 tar shards of
# 1,000 unique captions each, 8 steps of 128; an image folder of 128
# 224 x 224 arrays in 8 classes; the synthetic text-classification sets
RECIPE_SAMPLES, RECIPE_IMAGES, RECIPE_CLASSES, RECIPE_TEXTS = 1024, 128, 8, 64


def _write_tar_set(root: str, rng, shards: int = 3, per_shard: int = 1000):
    """`shards` tar files of unique seeded captions of 3-58 words."""
    import io
    import tarfile
    os.makedirs(root)
    seen = set()
    for s in range(shards):
        with tarfile.open(os.path.join(root, f"{s:03d}.tar"), "w") as tf:
            i = 0
            while i < per_shard:
                cap = _captions(rng, 1, 3, 58)[0]
                if cap in seen:
                    continue
                seen.add(cap)
                payload = cap.encode()
                info = tarfile.TarInfo(f"{s:03d}_{i:05d}.txt")
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
                i += 1
    return os.path.join(root, "{000..%03d}.tar" % (shards - 1))


def _write_image_folder(root: str, rng, n: int, classes: int, size: int):
    """`n` seeded HWC uint8 arrays as `.npy` files in `classes` folders."""
    for i in range(n):
        cdir = os.path.join(root, f"class_{i % classes:02d}")
        os.makedirs(cdir, exist_ok=True)
        np.save(os.path.join(cdir, f"{i:04d}.npy"),
                rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return root


def _eval_encodes(args, n_images: int):
    """(text encodes, image encodes) of one `zero_shot_eval` with the
    ImageNet split and both synthetic text sets: the classifier's calls of
    10 classes, 3 a chunk of 16 sentences (probes, candidates, templated
    scoring); per image batch the clean encode, one per PGD step and the
    adversarial encode, and one anchor encode per text set."""
    chunks = -(-args.n_val_text // 16)
    text = -(-1000 // 10) + 2 * 3 * chunks
    image = -(-n_images // args.batch_size) * (args.n_steps_adv + 2) + 2
    return text, image


class _EvalLaunches:
    """Wraps the driver's `zero_shot_eval`: the kernels' counters are
    zeroed just before each eval and read just after it."""

    def __init__(self, driver, counters):
        self.driver, self.counters = driver, counters
        self.inner = driver.zero_shot_eval
        self.calls = []

    def __call__(self, *args, **kwargs):
        import torch
        self.counters.zero()
        out = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append({name: op.launches
                           for name, op in self.counters.ops.items()})
        return out

    def __enter__(self):
        self.driver.zero_shot_eval = self
        return self

    def __exit__(self, *exc):
        self.driver.zero_shot_eval = self.inner


def phase_eval_parity(workdir: str):
    """ViT-tiny-test, fp32, TF32 off: `zero_shot_eval` on the card and on
    the CPU from the same weights gives the same clean top-1/top-5 and
    text accuracies, and the Charmer classification attack the same
    sentences."""
    import torch
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.attacks.text import (
        attack_text_charmer_classification_batched)
    from leaf_tpu_torch.data import get_data
    from leaf_tpu_torch.evals import zero_shot as zs
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.models.preprocess import image_transform
    from leaf_tpu_torch.train import params

    root = _write_image_folder(os.path.join(workdir, "tiny_imagenet"),
                               np.random.default_rng(11), 16, 4, 80)
    args = params.parse_args([
        "--model", "ViT-tiny-test", "--dataset-type", "synthetic",
        "--imagenet-val", root, "--n_val_imagenet", "16", "--batch-size",
        "8", "--val-text-classification", "synthetic", "--n_val_text", "16",
        "--n_charmer_test", "5", "--zeroshot-frequency", "1", "--seed", "2"])
    pre = image_transform(64, do_normalize=False)
    tok = get_tokenizer("ViT-tiny-test")
    runs = {}
    with zs.fp32_products():
        for device in ("cpu", "cuda"):
            model = create_model("ViT-tiny-test", precision="fp32", seed=0,
                                 device=device)
            model.module.visual.requires_grad_(False)
            data = get_data(args, pre)
            scorer = CandidateScorer(model.cfg, device)
            t0 = time.perf_counter()
            metrics = zs.zero_shot_eval(
                model.module, model.cfg, data, tok, pre, 1, args,
                scorer=scorer,
                generator=torch.Generator(device=device).manual_seed(2))
            dt = time.perf_counter() - t0
            # every image's five best classes, from one more classifier
            images, _ = next(iter(data["imagenet-val"].loader))
            with torch.no_grad():
                logits = zs._clean_logits(
                    model.module.visual, model.cfg,
                    torch.from_numpy(images).to(device),
                    zs._classifier(scorer, model.module.text, tok))
            top5 = logits.topk(5, dim=-1).indices.cpu().numpy()
            textcls = data["train-agnews"]
            anchors = zs.encode_anchor_images(model.module.visual, model.cfg,
                                              textcls, pre)
            sentences = [s["text"] for s in textcls.samples]
            adv = attack_text_charmer_classification_batched(
                scorer, model.module.text, tok, sentences, anchors,
                [s["label"] for s in textcls.samples], n=5,
                vocab=textcls.vocab)
            runs[device] = (metrics, adv, anchors.cpu(), dt, top5)
    (cm, ca, cf, cdt, c5), (gm, ga, gf, gdt, g5) = runs["cpu"], runs["cuda"]
    require(np.array_equal(g5, c5), "the images' five best classes differ "
            "between the card and the CPU")
    adv_key = "imagenet-zeroshot-val-top1-adv"
    same = {k: v for k, v in cm.items() if k != adv_key}
    require({k: v for k, v in gm.items() if k != adv_key} == same,
            f"eval metrics on the card {gm} against the CPU's {cm}")
    require(ga == ca, "the Charmer classification attack picks other "
            "sentences on the card than on the CPU")
    err = float((gf - cf).abs().max())
    require(err <= 1e-4, f"anchor features differ by {err}")
    changed = sum(a != s for a, s in zip(ga, sentences))
    say(f"(k) eval parity, ViT-tiny-test fp32, TF32 off, card vs CPU: "
        f"{same} equal; PGD top-1 card {gm[adv_key]} / CPU {cm[adv_key]} "
        f"(other generators); the same {len(ga)} adversarial sentences "
        f"({changed} changed); the {len(g5)} images' five best of 1000 "
        f"classes the same; anchor features max abs diff {err:.3g}; "
        f"eval {gdt:.2f} s on the card, {cdt:.2f} s on the CPU")
    return {"metrics": same, "anchor_err": err}


RECIPE_FLAGS = ["--model", MODEL, "--precision", "bf16", "--batch-size",
                "128", "--rho", "50", "--k_adv", "1", "--k_adv_test", "1",
                "--n_charmer_test", "20", "--constrain", "--lr", "1e-5",
                "--wd", "1e-4", "--warmup", "2", "--lr-scheduler", "cosine",
                "--epochs", "1", "--seed", "1", "--zeroshot-frequency", "1",
                "--save-frequency", "1", "--delete-previous-checkpoint",
                "--dataset-type", "webdataset",
                "--train-num-samples", str(RECIPE_SAMPLES),
                "--n_val_imagenet", str(RECIPE_IMAGES),
                "--val-text-classification", "synthetic",
                "--n_val_text", str(RECIPE_TEXTS),
                "--log-every-n-steps", "1", "--device", "cuda"]


def phase_recipe(workdir: str):
    """`driver.main` with the recipe's flags on local files at full width
    and depth, the kernels' launches held during each eval; then the fused
    and the unfused loop over the same tar set, one epoch each, no evals."""
    import torch
    from leaf_tpu_torch.attacks import edits
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.data import get_data
    from leaf_tpu_torch.models.factory import get_tokenizer
    from leaf_tpu_torch.train import driver, fused, loop, params, step

    rng = np.random.default_rng(12)
    tars = _write_tar_set(os.path.join(workdir, "tars"), rng)
    folder = _write_image_folder(os.path.join(workdir, "imagenet"), rng,
                                 RECIPE_IMAGES, RECIPE_CLASSES, 224)
    flags = RECIPE_FLAGS + ["--train-data", tars, "--imagenet-val", folder,
                            "--logs", workdir, "--name", "recipe"]
    args = params.parse_args(flags)
    counters = _Counters()
    handler = _Steps()
    log = logging.getLogger("leaf_tpu_torch.train.loop")
    log.addHandler(handler)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _EvalLaunches(driver, counters) as evals:
            out = driver.main(flags)
        wall = time.perf_counter() - t0
        steps = list(handler.steps)
        cfg = out["cfg"]
        text_enc, image_enc = _eval_encodes(args, RECIPE_IMAGES)
        want = {"packed_attention": cfg.text.layers * text_enc
                + cfg.vision.layers * image_enc,
                "fused_attention_block": cfg.text.layers * text_enc
                + cfg.vision.layers * image_enc,
                "layer_norm": (cfg.text.layers + 1) * text_enc
                + (cfg.vision.layers + 2) * image_enc}
        require(len(evals.calls) == 2, f"{len(evals.calls)} evals, 2 expected")
        eval_launches = dict.fromkeys(want, 0)
        for epoch, got in enumerate(evals.calls):
            say(f"(k) launches during the epoch-{epoch} eval: {got}; "
                f"{text_enc} text encodes ({-(-1000 // 10)} classifier calls "
                f"+ 2 sets x {-(-args.n_val_text // 16)} chunks x 3) and "
                f"{image_enc} image encodes (1 batch x (clean + "
                f"{args.n_steps_adv} PGD + adversarial) + 2 anchor sets) "
                f"expected = {want}")
            for name in want:
                require(got[name] == want[name], f"eval {epoch}: {name} "
                        f"{got[name]} launches, {want[name]} expected")
                eval_launches[name] += got[name]
        rows = _csv_rows(os.path.join(out["out_dir"], "results.csv"))
        require([r["epoch"] for r in rows] == ["0", "1"], f"rows {rows}")
        columns = driver.RESULT_COLUMNS[2:]
        for r in rows:
            vals = {c: float(r[c]) for c in columns}
            require(all(np.isfinite(v) and 0.0 <= v <= 1.0
                        for v in vals.values()), f"eval columns {vals}")
            say(f"(k) results.csv epoch {r['epoch']}: train_loss "
                f"{r['train_loss']}, {vals}")
        require(len(steps) == RECIPE_SAMPLES // 128, f"{len(steps)} steps")
        train_s = float(sum(a[5] for a in steps))
        parts = out["eval_seconds"]
        eval_s = {e: float(sum(p.values())) for e, p in parts.items()}
        for e, p in parts.items():
            say(f"(k) eval at epoch {e}: " + ", ".join(
                f"{k} {v:.2f} s" for k, v in p.items())
                + f"; {eval_s[e]:.2f} s in all")
        say(f"(k) driver.main: {wall:.1f} s wall; the epoch's {len(steps)} "
            f"steps {train_s:.2f} s (losses "
            f"{[round(a[8], 4) for a in steps]}); the two evals "
            f"{eval_s[0] + eval_s[1]:.2f} s; an eval is "
            f"{eval_s[1] / (eval_s[1] + train_s):.2f} of an epoch of "
            f"{len(steps)} steps plus its eval; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        recipe = {"wall_s": wall, "train_s": train_s, "eval_s": eval_s,
                  "eval_parts_s": parts, "eval_launches": eval_launches,
                  "rows": rows}
        state, frozen = out["state"], out["frozen_text"]
        shutil.rmtree(os.path.join(out["out_dir"], "checkpoints"))
        del out
        torch.cuda.empty_cache()

        # ---- fused and unfused over the same tar set, one epoch each
        tok = get_tokenizer(MODEL)
        scorer = CandidateScorer(cfg, "cuda")
        fs = fused.FusedLeafStep(cfg, tok, rho=RHO, k=K, device="cuda")
        loops = {}
        for tag, fused_step, epoch in (("fused", fs, 1), ("unfused", None, 2)):
            data = {"train": get_data(args, None, text_only=True)["train"]}
            handler.steps.clear()
            seconds = {"host": 0.0, "device": 0.0}
            before = _fused_marks(fs)
            counters.zero()
            loop.train_one_epoch_text_only(
                state, frozen, scorer, step.make_anchor_encode(),
                step.make_train_step(), tok, edits.DEFAULT_VOCAB, data, epoch,
                args,
                rng=np.random.default_rng(13), seconds=seconds,
                fused_step=fused_step)
            torch.cuda.synchronize()
            name = f"{tag} loop, recipe tar set (unique captions of 3-58 words)"
            loops[tag] = (_report_fused(name, handler.steps, before, fs)
                          if fused_step is not None else
                          _report_unfused(name, handler.steps, seconds))
        f_sps, u_sps = (loops[t]["samples_per_s"] for t in ("fused", "unfused"))
        say(f"(k) fused {f_sps:.1f} against unfused {u_sps:.1f} samples/s "
            f"over one epoch of the tar set: fused/unfused "
            f"{f_sps / u_sps:.3f}")
        recipe["loops"] = loops
    finally:
        log.removeHandler(handler)
    return eval_launches, recipe


# ---------------------------------------------------------------------------
# (l) the text attacks and the standalone evals
# ---------------------------------------------------------------------------

# the card-against-CPU sentences of (l): ASCII, one word with no slot to
# spare, punctuation
CHARMER_SENTENCES = ["a photo of a cat", "stocks fall!", "x",
                     "two dogs run near the old river bank"]


def _write_coco_set(root: str, rng, n: int, size: int, captions: int = 5):
    """`n` seeded HWC uint8 `.npy` images with `captions` seeded captions
    each, and their Karpathy-format annotation file."""
    os.makedirs(root)
    ann = []
    for i in range(n):
        np.save(os.path.join(root, f"{i:04d}.npy"),
                rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        ann.append({"image": f"{i:04d}.npy",
                    "caption": [c.capitalize() + "." for c in
                                _captions(rng, captions, 5, 14)]})
    path = os.path.join(root, "annotation.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


class _Part:
    """One part of (l) or (m): the kernels' counters zeroed and the device
    memory's peak reset just before; just after, the counters held to the
    towers' encodes on the card (a fused block and its attention per
    layer, and `ln_2` per layer + `ln_final` per text encode, `ln_pre`,
    `ln_2` per layer and `ln_post` per image encode), and one line with
    the part's seconds, the candidates its scorers encoded (padding
    included) per second, its scoring calls and the encodes (chunks) they
    made, and the peak device memory.  Encodes are counted by wrapping the
    towers' `encode_text`/`encode_image`, scorers by wrapping
    `CandidateScorer.__init__`; the scoring calls (each ends in a copy to
    the host) and the model builds are timed by wrapping them too.
    `layers`: the towers' depths (ViT-L's by default)."""

    def __init__(self, counters, tag: str, out: dict, layers=None,
                 phase: str = "l"):
        self.counters, self.tag, self.out = counters, tag, out
        self.layers = layers or {"text": 12, "image": 24}
        self.phase = phase

    def __enter__(self):
        import torch
        from leaf_tpu_torch.attacks.engine import CandidateScorer
        from leaf_tpu_torch.models import factory
        from leaf_tpu_torch.models.clip import TextTower, VisionTower
        self.encodes = {"text": 0, "image": 0}
        self.clock = {"scoring": 0.0, "build": 0.0}
        self.scorers = []
        part = self

        def timed(inner, kind):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return inner(*args, **kwargs)
                finally:
                    part.clock[kind] += time.perf_counter() - t0
            return wrapper

        from torch._subclasses.fake_tensor import is_fake

        def counted(cls, name, kind):
            inner = getattr(cls, name)

            def wrapper(self, x, *args, **kwargs):
                # a `torch.export` trace runs the towers on fake tensors,
                # which launch nothing
                if x.is_cuda and not is_fake(x):
                    part.encodes[kind] += 1
                return inner(self, x, *args, **kwargs)
            return inner, wrapper

        def collect(inner):
            def init(self, *args, **kwargs):
                inner(self, *args, **kwargs)
                part.scorers.append(self)
            return init

        self.saved = []
        for cls, name, kind in ((TextTower, "encode_text", "text"),
                                (VisionTower, "encode_image", "image")):
            inner, wrapper = counted(cls, name, kind)
            self.saved.append((cls, name, inner))
            setattr(cls, name, wrapper)
        self.saved.append((CandidateScorer, "__init__",
                           CandidateScorer.__init__))
        CandidateScorer.__init__ = collect(CandidateScorer.__init__)
        for name in ("score_rows", "score_flat", "score_classification_rows",
                     "score_classification"):
            self.saved.append((CandidateScorer, name,
                               getattr(CandidateScorer, name)))
            setattr(CandidateScorer, name,
                    timed(getattr(CandidateScorer, name), "scoring"))
        from leaf_tpu_torch.train import driver
        for module in (factory, driver):   # the driver imported its own name
            self.saved.append((module, "create_model", module.create_model))
            module.create_model = timed(module.create_model, "build")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.counters.zero()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        torch.cuda.synchronize()
        seconds = time.perf_counter() - self.t0
        for cls, name, inner in self.saved:
            setattr(cls, name, inner)
        if exc_type is not None:
            return False
        counts = {k: sum(s.counts[k] for s in self.scorers)
                  for k in ("calls", "encodes", "candidates")}
        layers = self.layers
        t, i = self.encodes["text"], self.encodes["image"]
        want = {"packed_attention": layers["text"] * t + layers["image"] * i,
                "fused_attention_block": layers["text"] * t
                + layers["image"] * i,
                "layer_norm": (layers["text"] + 1) * t
                + (layers["image"] + 2) * i}
        got = {name: op.launches for name, op in self.counters.ops.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        per_call = counts["encodes"] / max(counts["calls"], 1)
        scoring = self.clock["scoring"]
        rate = counts["candidates"] / max(scoring, 1e-9)
        say(f"({self.phase}) {self.tag}: {seconds:.2f} s ({self.clock['build']:.2f} s "
            f"of it building models, {scoring:.2f} s in scoring calls); "
            f"{counts['candidates']} candidates scored in {counts['calls']} "
            f"scoring calls of {per_call:.2f} chunks on average "
            f"({counts['encodes']} encodes), {rate:.0f} candidates/s in "
            f"them; peak device memory {peak:.1f} GiB; launches {got}, {t} "
            f"text + {i} image encodes expected = {want}")
        for name in want:
            require(got[name] == want[name], f"{self.tag}: {name} "
                    f"{got[name]} launches, {want[name]} expected")
            self.counters.total[name] += got[name]
        require(counts["encodes"] <= t and t > 0,
                f"{self.tag}: {counts['encodes']} scoring encodes of {t}")
        self.out[self.tag] = {
            "seconds": seconds, "build_s": self.clock["build"],
            "scoring_s": scoring, "candidates": counts["candidates"],
            "candidates_per_s": rate, "scoring_calls": counts["calls"],
            "chunks_per_call": per_call, "text_encodes": t,
            "image_encodes": i, "peak_gib": peak, "launches": got}
        return False


def phase_charmer_parity(workdir: str):
    """ViT-tiny-test, fp32, TF32 off, the card against the CPU from the
    same weights: the batched Charmer (free and constrained),
    bruteforce and one `--use_charmer` attack pick the same sentences,
    and the three evals give the same metrics (TextFARE's drifts to 1e-4
    relative, with the same adversarial sentences)."""
    import types

    import torch
    from leaf_tpu_torch.attacks import edits
    from leaf_tpu_torch.attacks import text as attacks
    from leaf_tpu_torch.attacks.constraint import WordConstraint
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.data.coco import get_coco_retrieval
    from leaf_tpu_torch.data.textcls import TextClassificationData
    from leaf_tpu_torch.evals import retrieval, textfare, zero_shot_text
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.models.preprocess import image_transform
    from leaf_tpu_torch.train import loop, step

    tiny = "ViT-tiny-test"
    tok = get_tokenizer(tiny)
    wc = WordConstraint()
    ann = _write_coco_set(os.path.join(workdir, "tiny_coco"),
                          np.random.default_rng(21), 6, 72)
    pre = image_transform(64, do_normalize=False)
    samples, _ = textfare._load_eval_samples("synthetic", 6)
    textcls = TextClassificationData.from_samples(
        "agnews", [dict(s, label=i % 4) for i, s in enumerate(samples)])
    captions = _captions(np.random.default_rng(22), 6, 3, 12)
    args = types.SimpleNamespace(use_charmer=True, rho=5, k_adv=1,
                                 attack_objective="l2")
    runs = {}
    with fp32_products():
        for device in ("cpu", "cuda"):
            model = create_model(tiny, precision="fp32", seed=0, device=device)
            clean = create_model(tiny, precision="fp32", seed=1, device=device)
            text = model.module.text
            scorer = CandidateScorer(model.cfg, device)
            anchors = scorer.encode_text(text, tok(CHARMER_SENTENCES))
            r = {"free": attacks.attack_text_charmer_batched(
                     scorer, text, tok, CHARMER_SENTENCES, anchors, n=5, k=2),
                 "constrained": attacks.attack_text_charmer_batched(
                     scorer, text, tok, CHARMER_SENTENCES, anchors, n=5,
                     k=2, constraint=wc),
                 "bruteforce": [attacks.attack_text_bruteforce(
                     scorer, text, tok, s, anchors[i])[0]
                     for i, s in enumerate(CHARMER_SENTENCES[:2])]}
            frozen = step.make_anchor_encode()(
                clean.module.text, scorer._put(scorer._bucket(tok(captions))))
            r["use_charmer"] = loop.run_attack(
                scorer, text, tok, captions, frozen, args,
                edits.DEFAULT_VOCAB, None, None)
            csv_path = os.path.join(workdir, f"textfare_{device}.csv")
            r["textfare"] = textfare.eval_textfare(
                scorer, text, clean.module.text, tok, samples, "charmer",
                rho=5, out_csv=csv_path, attack_batch=4)
            r["textfare_sentences"] = [row["adv_sentence"]
                                       for row in _csv_rows(csv_path)]
            label_feats = zero_shot_text.class_anchor_features(
                scorer, model.module, tok, textcls, "image", pre)
            r["zero_shot_text"] = zero_shot_text.eval_zero_shot_text(
                scorer, text, tok, textcls, label_feats, rho=5, chunk_size=4)
            ds = get_coco_retrieval(os.path.dirname(ann), ann, pre)
            embeds = retrieval.embed_images(model, ds.image_batches())
            out = retrieval.eval_retrieval(
                scorer, text, tok, embeds, ds.text, ds.img2txt, ds.txt2img,
                target=0, rho=5, attack_batch=8)
            r["retrieval"] = out
            runs[device] = r
    cpu, card = runs["cpu"], runs["cuda"]
    for key in ("free", "constrained", "bruteforce", "use_charmer",
                "textfare_sentences", "zero_shot_text", "retrieval"):
        require(card[key] == cpu[key], f"(l) {key}: the card gives "
                f"{card[key]}, the CPU {cpu[key]}")
    for key in ("textfare_clean", "textfare_adv"):
        a, b = card["textfare"][key], cpu["textfare"][key]
        require(abs(a - b) <= 1e-4 * max(abs(b), 1e-6),
                f"(l) TextFARE {key}: card {a}, CPU {b}")
    changed = {k: sum(a != s for a, s in zip(card[k], CHARMER_SENTENCES))
               for k in ("free", "constrained", "bruteforce")}
    say(f"(l) Charmer parity, ViT-tiny-test fp32, TF32 off, card vs CPU: "
        f"the same sentences from the batched Charmer free and constrained "
        f"(k 2), bruteforce and one --use_charmer attack (changed: "
        f"{changed}); TextFARE {card['textfare']} (CPU {cpu['textfare']}) "
        f"with the same adversarial sentences; zero-shot text "
        f"{card['zero_shot_text']}; retrieval clean {card['retrieval']['clean']}"
        f", adversarial {card['retrieval']['adv']}: equal")
    return {"textfare": card["textfare"],
            "zero_shot_text": card["zero_shot_text"],
            "retrieval": {k: card["retrieval"][k] for k in ("clean", "adv")}}


CHARMER_FLAGS = TRAIN_FLAGS + ["--use_charmer"]


def phase_text_attacks(workdir: str):
    """The text attacks and the standalone evals at ViT-L-14-quickgelu's
    full width and depth (random weights, seed 0), each part through its
    command line's `main`, on the card."""
    import torch
    from leaf_tpu_torch.evals import retrieval, textfare, zero_shot_text
    from leaf_tpu_torch.train import driver

    counters = _Counters()
    out = {}
    evals_dir = os.path.join(workdir, "text_evals")
    tf_flags = ["--model", MODEL, "--dataset", "synthetic", "--rho", "50",
                "--output-dir", evals_dir, "--device", "cuda"]
    for tag, extra in (
            ("textfare charmer bf16, 32 sentences",
             ["--attack_name", "charmer", "--n_test", "32", "--precision",
              "bf16"]),
            ("textfare leaf bf16, 32 sentences",
             ["--attack_name", "leaf", "--n_test", "32", "--precision",
              "bf16"]),
            ("textfare charmer fp32, 8 sentences",
             ["--attack_name", "charmer", "--n_test", "8", "--precision",
              "fp32"]),
            ("textfare bruteforce bf16, 4 sentences",
             ["--attack_name", "bruteforce", "--n_test", "4", "--precision",
              "bf16"])):
        with _Part(counters, tag, out):
            res = textfare.main(tf_flags + extra)
        require(res["n"] == int(extra[3]) and np.isfinite(res["textfare_adv"])
                and res["textfare_adv"] > res["textfare_clean"] == 0.0,
                f"{tag}: {res}")
        out[tag]["result"] = res
        say(f"(l) {tag}: {res}")

    tag = "zero_shot_text, 32 sentences, image anchors, bf16"
    with _Part(counters, tag, out):
        res = zero_shot_text.main([
            "--model", MODEL, "--dataset", "synthetic", "--rho", "20", "--k",
            "1", "--n_test", "32", "--label-encoder", "image", "--precision",
            "bf16", "--output-dir", evals_dir, "--device", "cuda"])
    require(res["n"] == 32 and 0.0 <= res["acc_adv"] <= 1.0
            and 0.0 <= res["acc"] <= 1.0, f"{tag}: {res}")
    rows = _csv_rows(os.path.join(
        evals_dir, f"{MODEL}_agnews_k1_rho_20_image.csv"))
    require(len(rows) == 32, f"{tag}: {len(rows)} CSV rows")
    out[tag]["result"] = res
    say(f"(l) {tag}: {res}")

    ann = _write_coco_set(os.path.join(workdir, "coco"),
                          np.random.default_rng(23), 32, 256)
    for target in (None, 0):
        tag = ("retrieval, 32 images x 5 captions, bf16, "
               + ("untargeted" if target is None else f"target {target}"))
        output = os.path.join(workdir, f"retrieval_{target}.json")
        with _Part(counters, tag, out):
            res = retrieval.main(
                ["--model", MODEL, "--coco-root", os.path.dirname(ann),
                 "--annotation", ann, "--rho", "10", "--precision", "bf16",
                 "--output", output, "--device", "cuda"]
                + ([] if target is None else ["--target", str(target)]))
        vals = [v for d in res.values() for v in d.values()]
        require(all(0.0 <= v <= 1.0 for v in vals), f"{tag}: {res}")
        require(len(_csv_rows(output.replace(".json", "_perturbations.csv")))
                == 160, f"{tag}: perturbations")
        out[tag]["result"] = res
        say(f"(l) {tag}: {res}")

    handler = _Steps()
    log = logging.getLogger("leaf_tpu_torch.train.loop")
    log.addHandler(handler)
    tars = os.path.join(workdir, "tars", "{000..002}.tar")
    try:
        for tag, extra, n_steps in (
                ("--use_charmer, 'Dummy caption', 2 steps",
                 ["--train-num-samples", "256", "--name", "charmer"], 2),
                ("--use_charmer --constrain, recipe tar set, 1 step",
                 ["--train-num-samples", "128", "--dataset-type",
                  "webdataset", "--train-data", tars, "--constrain",
                  "--name", "charmer_constrained"], 1)):
            handler.steps.clear()
            with _Part(counters, tag, out):
                res = driver.main(CHARMER_FLAGS + ["--logs", workdir] + extra)
            steps = list(handler.steps)
            losses = [a[8] for a in steps]
            require(len(steps) == n_steps and all(
                np.isfinite(v) and v > 0 for v in losses),
                f"{tag}: steps {steps}")
            with open(os.path.join(res["out_dir"], "times_True.csv")) as f:
                times = f.read().split()
            require(len(times) == 1 + n_steps, f"{tag}: times_True.csv")
            part = out[tag]
            step_s = float(np.mean([a[5] for a in steps]))
            attack_s = float(np.mean([a[7] for a in steps]))
            part.update(step_s=step_s, attack_s=attack_s, losses=losses,
                        step_candidates_per_s=part["candidates"] / n_steps
                        / step_s,
                        attack_seconds=res["attack_seconds"])
            say(f"(l) {tag}: {step_s:.2f} s a step (attack {attack_s:.2f} "
                f"s: host {res['attack_seconds']['host'] / n_steps:.2f} s, "
                f"scoring {res['attack_seconds']['device'] / n_steps:.2f} "
                f"s), {part['step_candidates_per_s']:.0f} candidates/s, "
                f"losses {[round(v, 4) for v in losses]}")
            shutil.rmtree(os.path.join(res["out_dir"], "checkpoints"))
            del res
            torch.cuda.empty_cache()
    finally:
        log.removeHandler(handler)
    return counters.total, out


# ---------------------------------------------------------------------------
# (m) FARE adversarial training and the ImageNet robust eval
# ---------------------------------------------------------------------------

FARE_MODEL = "ViT-H-14"
FARE_IMAGES, FARE_CLASSES, FARE_STEPS = 256, 8, 3
ROBUST_IMAGES = 32
# scripts/train_fare_vith.sh's flags, but for the schedule: 3 steps after 1
# warm-up step where the recipe warms up for 700 of its 10,000
FARE_FLAGS = ["--model", FARE_MODEL, "--precision", "bf16", "--batch-size",
              "128", "--loss", "l2", "--inner-loss", "l2", "--opt", "adamw",
              "--lr", "1e-5", "--wd", "1e-4", "--attack", "pgd", "--norm",
              "linf", "--eps", "2", "--iterations-adv", "10",
              "--stepsize-adv", "1", "--warmup", "1", "--log-freq", "1",
              "--seed", "0", "--device", "cuda"]
# the eval's defaults are 100 APGD iterations, 3 targets and 1,000 Square
# iterations; 1,000 images where the run has 32
ROBUST_FLAGS = ["--model", FARE_MODEL, "--n-samples", str(ROBUST_IMAGES),
                "--attack-iters", "10", "--n-targets", "1", "--square",
                "--square-iters", "20", "--seed", "0", "--device", "cuda"]


def _fare_launches(layers: int, encodes: int, differentiated: int,
                   remat: bool):
    """Launches of each packed kernel and of the LayerNorm op for `encodes`
    forward-only image encodes and `differentiated` ones: a block per layer
    (twice under remat: the forward and its recompute in the backward;
    the backward itself recomputes through the plain versions), `ln_2`
    with each block, and `ln_pre` and `ln_post` once an encode."""
    blocks = layers * (encodes + (2 if remat else 1) * differentiated)
    return {"packed_attention": blocks, "fused_attention_block": blocks,
            "layer_norm": blocks + 2 * (encodes + differentiated)}


def phase_fare_parity(workdir: str):
    """ViT-tiny-test, fp32, TF32 off, the card against the CPU from the same
    weights: 2 FARE steps with PGD from the same starts and 2 with APGD (on
    the cross-entropy) give the same losses and parameters (1e-4), the APGD
    cascade and Square the same fooled masks and images; then
    `fare_driver.main` on the card, 3 steps and a resume to 5."""
    import torch
    from leaf_tpu_torch.attacks.square import make_margin_loss_fn, square_attack
    from leaf_tpu_torch.benchmark.zeroshot_classification import (
        _apgd_attack_batch, _logits_fn)
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.train import checkpoint, fare, fare_driver

    tiny, eps = "ViT-tiny-test", 8 / 255
    rng = np.random.default_rng(31)
    images = rng.uniform(0.2, 0.8, (4, 64, 64, 3)).astype(np.float32)
    starts = [(eps * (2 * rng.random(images.shape) - 1)).astype(np.float32)
              for _ in range(2)]
    clf = rng.standard_normal((64, 10)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0)
    targets = np.arange(4)
    runs = {}
    with fp32_products():
        for device in ("cpu", "cuda"):
            r = {}
            for attack in ("pgd", "apgd"):
                model = create_model(tiny, seed=0, device=device,
                                     master_weights=True)
                # APGD has no random start: on the l2 loss it would start
                # where the trainable and the frozen tower agree, at a zero
                # gradient, so it maximises the cross-entropy instead
                fcfg = fare.FareConfig(
                    steps=2, warmup=1, lr=1e-4, eps=eps, iterations_adv=3,
                    stepsize_adv=eps / 2, attack=attack, log_freq=1,
                    inner_loss="l2" if attack == "pgd" else "ce")
                losses = []
                out = fare.train_fare(
                    model.module.visual, model.cfg, fcfg,
                    iter([(images, targets)] * 2),
                    classifier=torch.from_numpy(clf).to(device), seed=0,
                    starts=(torch.from_numpy(s).to(device) for s in starts),
                    on_step=lambda s, m: losses.append(m["loss"]))
                r[attack] = (losses, {k: v.cpu() for k, v in
                                      out["visual"].state_dict().items()})
            model = create_model(tiny, seed=0, device=device,
                                 master_weights=True)
            model.module.requires_grad_(False)
            visual = model.module.visual
            clf_t = torch.from_numpy(clf).to(device)
            x = torch.from_numpy(images).to(device)
            logits_fn = _logits_fn(visual, model.cfg, clf_t)
            with torch.no_grad():
                labels = logits_fn(x).argmax(-1)
            adv, fooled = _apgd_attack_batch(visual, model.cfg, clf_t, x,
                                             labels, 4 / 255, n_iter=6,
                                             n_targets=2)
            mfn = make_margin_loss_fn(logits_fn, labels.cpu().numpy(), device)
            sq = square_attack(mfn, images, eps=eps, n_iters=15, seed=0)
            r["cascade"] = (adv.cpu().numpy(), fooled.cpu().numpy())
            r["square"] = (sq, mfn(sq)[1].cpu().numpy())
            runs[device] = r
    cpu, card = runs["cpu"], runs["cuda"]
    worst = {}
    for attack in ("pgd", "apgd"):
        (cl, cp), (gl, gp) = cpu[attack], card[attack]
        require(np.allclose(gl, cl, rtol=1e-4, atol=1e-6),
                f"(m) {attack} losses: card {gl}, CPU {cl}")
        # the attention's key bias has a zero true gradient (softmax is
        # shift invariant): Adam turns rounding noise there into a step of
        # up to lr either way, so it is held to 2 lr a step (ROADMAP Queue 3)
        diff = {k: (gp[k] - cp[k]).abs() for k in cp}
        key_bias = max(float(d[d.shape[0] // 3:2 * d.shape[0] // 3].max())
                       for k, d in diff.items() if k.endswith("attn.qkv_b"))
        for k, d in diff.items():
            if k.endswith("attn.qkv_b"):
                d[d.shape[0] // 3:2 * d.shape[0] // 3] = 0
        worst[attack] = max(float(d.max()) for d in diff.values())
        require(worst[attack] <= 1e-4 and key_bias <= 2 * 2 * fcfg.lr,
                f"(m) {attack}: parameters differ by {worst[attack]}, the "
                f"key bias by {key_bias}")
    require(np.array_equal(card["cascade"][1], cpu["cascade"][1])
            and np.array_equal(card["square"][1], cpu["square"][1]),
            f"(m) fooled masks: card {card['cascade'][1]} "
            f"{card['square'][1]}, CPU {cpu['cascade'][1]} {cpu['square'][1]}")
    adv_err = float(np.abs(card["cascade"][0] - cpu["cascade"][0]).max())
    sq_err = float(np.abs(card["square"][0] - cpu["square"][0]).max())
    require(adv_err <= 1e-4 and sq_err <= 1e-4,
            f"(m) adversarial images differ by {adv_err} (APGD), {sq_err} "
            "(Square)")
    say(f"(m) FARE parity, ViT-tiny-test fp32, TF32 off, card vs CPU: 2 "
        f"steps PGD (same starts) losses {card['pgd'][0]} (CPU "
        f"{cpu['pgd'][0]}), parameters within {worst['pgd']:.3g}; 2 steps "
        f"APGD losses {card['apgd'][0]}, parameters within "
        f"{worst['apgd']:.3g}; the cascade fooled {card['cascade'][1]} and "
        f"Square {card['square'][1]} on both, images within {adv_err:.3g} / "
        f"{sq_err:.3g}")

    folder = _write_image_folder(os.path.join(workdir, "tiny_fare"),
                                 np.random.default_rng(32), 8, 2, 72)
    out_dir = os.path.join(workdir, "tiny_fare_out")
    flags = ["--model", tiny, "--imagenet-root", folder, "--batch-size", "4",
             "--iterations-adv", "2", "--warmup", "1", "--fallback-freq", "1",
             "--log-freq", "1", "--output-dir", out_dir, "--device", "cuda"]
    fare_driver.main(flags + ["--steps", "3"])
    ck = os.path.join(out_dir, "FARE", "checkpoints")
    saved = checkpoint.load_checkpoint(os.path.join(ck, "epoch_3"))
    out = fare_driver.main(flags + ["--steps", "5", "--resume", "latest"])
    names = sorted(os.listdir(ck))
    adam = out["state"].optimizer.adamw.state_dict()["state"]
    steps = {float(a["step"]) for a in adam.values()}
    require(saved["step"] == 3 and out["steps"] == 5 and steps == {5.0},
            f"(m) resume: saved step {saved['step']}, {out['steps']} steps, "
            f"Adam's steps {steps}")
    require(names == [f"epoch_{i}" for i in range(1, 6)],
            f"(m) checkpoints left: {names}")
    say(f"(m) fare_driver.main on the card, ViT-tiny-test: 3 steps, then "
        f"--resume latest --steps 5 from epoch_3 (step 3): Adam's step "
        f"counts {sorted(steps)}, checkpoints {names}, no fallback left")
    return {"pgd_param_err": worst["pgd"], "apgd_param_err": worst["apgd"],
            "cascade_err": adv_err, "square_err": sq_err}


class _FareRun:
    """Wraps `fare.train_fare` for one `fare_driver.main` call on the card:
    the kernels' counters are read each time the loop takes a batch and
    once when it returns (a step's launches are the difference of two
    reads), each step's loss is recorded, the trainable tower's parameters
    are copied to the host before training (the frozen tower is held to
    them after), and each checkpoint's host copy and disk write are
    timed."""

    def __init__(self, counters):
        self.counters = counters

    def __enter__(self):
        from leaf_tpu_torch.train import checkpoint, fare
        run = self
        self.reads, self.losses, self.saves, self.writes = [], [], [], []
        self.saved = [(fare, "train_fare", fare.train_fare),
                      (checkpoint, "save_checkpoint",
                       checkpoint.save_checkpoint),
                      (checkpoint, "_write", checkpoint._write)]

        def read():
            return {name: op.launches
                    for name, op in self.counters.ops.items()}

        def train_fare(visual, cfg, fcfg, data_iter, **kw):
            run.before = {k: v.detach().cpu().clone()
                          for k, v in visual.state_dict().items()}

            def batches():
                for batch in data_iter:
                    run.reads.append(read())
                    yield batch
            kw["on_step"] = lambda s, m: run.losses.append(m["loss"])
            out = self.saved[0][2](visual, cfg, fcfg, batches(), **kw)
            run.reads.append(read())
            return out

        def timed(inner, into):
            def wrapper(*args, **kw):
                t0 = time.perf_counter()
                inner(*args, **kw)
                into.append(time.perf_counter() - t0)
            return wrapper

        fare.train_fare = train_fare
        checkpoint.save_checkpoint = timed(checkpoint.save_checkpoint,
                                           self.saves)
        checkpoint._write = timed(checkpoint._write, self.writes)
        return self

    def __exit__(self, *exc):
        for module, name, inner in self.saved:
            setattr(module, name, inner)
        return False

    def launches(self):
        return [{k: b[k] - a[k] for k in a}
                for a, b in zip(self.reads, self.reads[1:])]


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e9


def phase_fare(workdir: str):
    """`fare_driver.main` with the recipe's flags at ViT-H-14's full width
    and depth (random weights, seed 0): 3 steps with remat, then 1 with
    `--no-remat`; each step's seconds and launches, the peak device memory,
    each checkpoint's seconds and size."""
    import torch
    from leaf_tpu_torch.models.clip import VisionTower
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.train import fare_driver

    cfg = get_model_config(FARE_MODEL)
    with torch.device("meta"):
        n_params = sum(p.numel() for p in VisionTower(cfg.vision).parameters())
    ckpt_gb = 3 * 4 * n_params / 1e9   # parameters and two moments, fp32
    free_gb = shutil.disk_usage(workdir).free / 1e9
    need_gb = (FARE_STEPS + 1) * ckpt_gb
    say(f"(m) {FARE_MODEL} vision tower: {n_params} parameters; a checkpoint "
        f"~{ckpt_gb:.2f} GB; {free_gb:.1f} GB free in {workdir}")
    require(free_gb > need_gb, f"(m) {free_gb:.1f} GB free in {workdir}, "
            f"{need_gb:.1f} GB needed for the checkpoints")
    folder = _write_image_folder(os.path.join(workdir, "fare_train"),
                                 np.random.default_rng(33), FARE_IMAGES,
                                 FARE_CLASSES, 256)
    counters = _Counters()
    layers = cfg.vision.layers
    iters = int(FARE_FLAGS[FARE_FLAGS.index("--iterations-adv") + 1])
    batch = int(FARE_FLAGS[FARE_FLAGS.index("--batch-size") + 1])
    results, total = {}, dict.fromkeys(counters.NAMES, 0)
    for tag, extra, n_steps, remat in (
            ("remat", [], FARE_STEPS, True),
            ("no-remat", ["--no-remat"], 1, False)):
        out_dir = os.path.join(workdir, f"fare_{tag}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counters.zero()
        t0 = time.perf_counter()
        with _FareRun(counters) as run:
            out = fare_driver.main(FARE_FLAGS + extra + [
                "--imagenet-root", folder, "--steps", str(n_steps),
                "--output-dir", out_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = _fare_launches(layers, 1, iters + 1, remat)
        steps = []
        for i, (t, got) in enumerate(zip(out["times"], run.launches())):
            require(got == want, f"(m) FARE {tag} step {i + 1}: launches "
                    f"{got}, {want} expected (1 anchor + {iters + 1} "
                    f"differentiated encodes of {layers} layers)")
            steps.append(dict(t, images_per_s=batch / t["step_s"],
                              launches=got))
            say(f"(m) FARE {tag} step {i + 1}: {t['step_s']:.3f} s on the "
                f"device, {batch / t['step_s']:.1f} images/s; anchor "
                f"{t['anchor_s']:.3f} s, attack {t['attack_s']:.3f} s, "
                f"update {t['update_s']:.3f} s; the loader kept the host "
                f"waiting {t['wait_s']:.3f} s; launches {got} (1 + "
                f"{iters + 1} differentiated encodes)")
        for name in counters.NAMES:
            got = sum(s["launches"][name] for s in steps)
            require(counters.ops[name].launches == got,
                    f"(m) FARE {tag}: {name} launched outside the steps")
            total[name] += got
        require(len(steps) == n_steps == out["steps"]
                and len(run.losses) == n_steps
                and all(np.isfinite(v) and v > 0 for v in run.losses),
                f"(m) FARE {tag}: steps {out['steps']}, losses {run.losses}")
        frozen = out["frozen"].state_dict()
        require(all(torch.equal(frozen[k].cpu(), v)
                    for k, v in run.before.items()),
                f"(m) FARE {tag}: the frozen tower changed")
        moved = max(float((v.cpu() - run.before[k]).abs().max())
                    for k, v in out["visual"].state_dict().items())
        require(moved > 0, f"(m) FARE {tag}: the trained tower did not move")
        ck = os.path.join(out_dir, "FARE", "checkpoints")
        sizes = {name: _dir_gb(os.path.join(ck, name))
                 for name in sorted(os.listdir(ck))}
        require(len(sizes) == len(run.writes) == len(run.saves),
                f"(m) FARE {tag}: checkpoints {sizes}, {len(run.writes)} "
                "writes")
        say(f"(m) FARE {tag}: {n_steps} steps in {seconds:.1f} s (model "
            f"build and checkpoints included), losses "
            f"{[round(v, 5) for v in run.losses]}, the largest parameter "
            f"change {moved:.3g}, the frozen tower unchanged; peak device "
            f"memory {peak:.1f} GiB; checkpoints {sizes} GB, each save "
            f"{[round(v, 2) for v in run.saves]} s on the host (the copy) "
            f"and {[round(v, 2) for v in run.writes]} s writing")
        results[tag] = {"seconds": seconds, "steps": steps,
                        "losses": run.losses, "peak_gib": peak,
                        "checkpoint_gb": list(sizes.values()),
                        "save_s": run.saves, "write_s": run.writes}
        shutil.rmtree(out_dir)
        del out, run, frozen
        torch.cuda.empty_cache()
    return total, results


def _robust_folder(workdir: str):
    """The eval's images, each in the class folder (of 1,000) that the
    model picks for it, so that every clean prediction is right and the
    attacks have work to do; then Square on them at full width (20
    iterations), outside the eval, where APGD may leave it nothing.
    Returns (folder, Square's seconds, its fooled count, its launches)."""
    import torch
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.attacks.square import make_margin_loss_fn, square_attack
    from leaf_tpu_torch.benchmark.zeroshot_classification import _logits_fn
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models import zero_shot
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.models.preprocess import image_transform, read_image

    arrays = _write_image_folder(os.path.join(workdir, "robust_arrays"),
                                 np.random.default_rng(34), ROBUST_IMAGES,
                                 1, 256)
    paths = sorted(os.path.join(d, f) for d, _, files in os.walk(arrays)
                   for f in files)
    model = create_model(FARE_MODEL, seed=0, device="cuda",
                         master_weights=True)
    model.module.requires_grad_(False)
    scorer = CandidateScorer(model.cfg, "cuda")
    pre = image_transform(model.cfg.vision.image_size, do_normalize=False)
    images = np.stack([pre(read_image(p)) for p in paths])
    with fp32_products():
        classifier = zero_shot.build_zero_shot_classifier(
            lambda t: scorer.encode_text(model.module.text, t),
            get_tokenizer(FARE_MODEL), zero_shot.imagenet_classnames(),
            zero_shot.openai_imagenet_templates())
    logits_fn = _logits_fn(model.module.visual, model.cfg, classifier)
    with torch.no_grad():
        classes = logits_fn(torch.from_numpy(images).cuda()).argmax(-1).cpu()
    folder = os.path.join(workdir, "robust_val")
    for c in range(1000):
        os.makedirs(os.path.join(folder, f"c{c:04d}"))
    for p, c in zip(paths, classes.tolist()):
        shutil.move(p, os.path.join(folder, f"c{c:04d}",
                                    os.path.basename(p)))
    mfn = make_margin_loss_fn(logits_fn, classes.numpy(), "cuda")
    pa = _Counters()
    pa.zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adv = square_attack(mfn, images, eps=2 / 255, n_iters=20, seed=0)
    fooled = int(mfn(adv)[1].sum())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: op.launches for name, op in pa.ops.items()}
    require(np.abs(adv - images).max() <= 2 / 255 + 1e-6,
            "(m) Square left the eps-ball")
    say(f"(m) Square at {FARE_MODEL}, fp32, {ROBUST_IMAGES} images the model "
        f"classifies as labelled, 20 iterations: {seconds:.2f} s, "
        f"{fooled} fooled, launches {launches}; the images go to "
        f"{len(set(classes.tolist()))} of 1000 class folders")
    del model, scorer, classifier, logits_fn, mfn
    torch.cuda.empty_cache()
    return folder, seconds, fooled, launches


def phase_robust(workdir: str):
    """`imagenet_robust.main` at ViT-H-14's full width and depth (fp32, TF32
    off), the kernels' launches held to its encodes."""
    from leaf_tpu_torch.evals import imagenet_robust
    from leaf_tpu_torch.models.config import get_model_config

    cfg = get_model_config(FARE_MODEL)
    folder, square_s, square_fooled, square_launches = _robust_folder(workdir)
    counters, out, seconds = _Counters(), {}, {}
    tag = (f"imagenet_robust {FARE_MODEL} fp32, {ROBUST_IMAGES} images, "
           "APGD 10 iterations x (CE + 1 target), Square 20 (defaults 100, "
           "3, 1000; 1000 images)")
    with _Part(counters, tag, out, {"text": cfg.text.layers,
                                    "image": cfg.vision.layers}, "m"):
        res = imagenet_robust.main(ROBUST_FLAGS + [
            "--imagenet-root", folder, "--output-dir",
            os.path.join(workdir, "robust_out")], seconds=seconds)
    clean, robust = res["clean_acc1"], res["robust_acc1"]
    require(res["n_samples"] == ROBUST_IMAGES and clean == 1.0
            and 0.0 <= robust <= clean, f"(m) robust eval: {res}")
    part = out[tag]
    part.update(result=res, part_seconds=seconds, square_alone_s=square_s,
                square_alone_fooled=square_fooled,
                square_alone_launches=square_launches)
    say(f"(m) robust eval: {res}; seconds by part "
        f"{ {k: round(v, 2) for k, v in seconds.items()} }")
    return counters.total, part


# ---------------------------------------------------------------------------
# (n) contrastive training at ViT-B-32
# ---------------------------------------------------------------------------

CLIP_MODEL, CLIP_BATCH = "ViT-B-32", 256
CLIP_SHARDS, CLIP_PER_SHARD = 8, 256
# OpenCLIP's LAION-400M ViT-B/32 run per GPU: batch 256 of its global
# 32,768, lr 5e-4, wd 0.2, the local loss; the cosine after 2 warm-up steps,
# since the cells are a few steps each
CLIP_FLAGS = ["--model", CLIP_MODEL, "--precision", "bf16", "--batch-size",
              str(CLIP_BATCH), "--lr", "5e-4", "--wd", "0.2", "--warmup",
              "2", "--local-loss", "--workers", "4", "--dataset-type",
              "webdataset", "--log-every-n-steps", "1", "--seed", "0",
              "--device", "cuda"]


def _write_pair_tars(root: str, rng, shards: int, per_shard: int,
                     size: int = 256) -> str:
    """`shards` tar files of seeded HWC uint8 `.npy` images, each with a
    caption of 3-30 words; returns the brace spec."""
    import io
    import tarfile
    os.makedirs(root)
    for s in range(shards):
        images = rng.integers(0, 256, (per_shard, size, size, 3),
                              dtype=np.uint8)
        with tarfile.open(os.path.join(root, f"{s:03d}.tar"), "w") as tf:
            for i, cap in enumerate(_captions(rng, per_shard, 3, 30)):
                buf = io.BytesIO()
                np.save(buf, images[i])
                for ext, payload in (("npy", buf.getvalue()),
                                     ("txt", cap.encode())):
                    info = tarfile.TarInfo(f"{s:03d}_{i:05d}.{ext}")
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
    return os.path.join(root, "{000..%03d}.tar" % (shards - 1))


def _clip_launches(cfg, encodes: int):
    """Launches of each packed kernel and of the LayerNorm op for
    `encodes` forward passes of both towers: a block per layer of each
    (the backward recomputes through the plain versions), `ln_2` with each
    block, `ln_final`, `ln_pre` and `ln_post` once a pass."""
    blocks = (cfg.text.layers + cfg.vision.layers) * encodes
    return {"packed_attention": blocks, "fused_attention_block": blocks,
            "layer_norm": blocks + 3 * encodes}


class _ContrastiveRun:
    """Wraps the step makers and the val eval of `contrastive_driver` for
    one `main` call: the kernels' counters are read just before and just
    after each step and each eval, each step's loss is kept, and each
    step's peak device memory (the allocator's peak, reset just before
    the step; no synchronise)."""

    NAMES = ("make_contrastive_train_step",
             "make_accum_contrastive_train_step", "make_distill_train_step",
             "evaluate_contrastive")

    def __init__(self, counters):
        self.counters = counters

    def _read(self):
        return {name: op.launches for name, op in self.counters.ops.items()}

    def _diff(self, before):
        after = self._read()
        return {k: after[k] - before[k] for k in after}

    def __enter__(self):
        from leaf_tpu_torch.train import contrastive_driver as cd
        self.cd = cd
        self.saved = {name: getattr(cd, name) for name in self.NAMES}
        self.steps, self.losses, self.evals = [], [], []
        self.sps, self.peaks = [], []
        run = self
        import torch

        def wrap_maker(maker):
            def make(*args, **kw):
                step_fn = maker(*args, **kw)

                def step(state, images, tokens):
                    torch.cuda.reset_peak_memory_stats()
                    before = run._read()
                    out = step_fn(state, images, tokens)
                    run.steps.append(run._diff(before))
                    run.peaks.append(torch.cuda.max_memory_allocated()
                                     / 2 ** 30)
                    run.losses.append(out[1]["loss"])
                    return out
                return step
            return make

        def evaluate(*args, **kw):
            before = run._read()
            metrics = run.saved["evaluate_contrastive"](*args, **kw)
            run.evals.append((run._diff(before), metrics))
            return metrics

        for name in self.NAMES[:3]:
            setattr(cd, name, wrap_maker(self.saved[name]))
        cd.evaluate_contrastive = evaluate

        class Rates(logging.Handler):
            def emit(self, record):
                if str(record.msg).startswith("Contrastive Epoch"):
                    run.sps.append(record.args[5])
        self.handler = Rates()
        logging.getLogger(cd.__name__).addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cd, name, fn)
        logging.getLogger(self.cd.__name__).removeHandler(self.handler)
        return False


def phase_contrastive_parity(workdir: str):
    """ViT-tiny-test, fp32, TF32 off, the card against the CPU from the
    same weights: two contrastive steps, plain and with the feature cache
    (k = 2), give the same losses and parameters (1e-4);
    `evaluate_contrastive` and the LEAF driver's `--val-data` give the same
    metrics."""
    import torch
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import contrastive, driver
    from leaf_tpu_torch.train.optim import make_optimizer

    tiny, lr = "ViT-tiny-test", 1e-4
    rng = np.random.default_rng(41)
    images = rng.standard_normal((2, 4, 64, 64, 3)).astype(np.float32)
    captions = _captions(rng, 8, 3, 30)
    tokenizer = get_tokenizer(tiny)
    tokens = np.asarray(tokenizer(captions)).reshape(2, 4, -1)
    val = _write_pair_tars(os.path.join(workdir, "tiny_val"), rng, 1, 8, 72)
    runs = {}
    with fp32_products():
        for device in ("cpu", "cuda"):
            r = {}
            for kind in ("plain", "accum"):
                model = create_model(tiny, seed=0, device=device,
                                     master_weights=True)
                state = contrastive.ContrastiveState(model.module, make_optimizer(
                    model.module.named_parameters(), lambda step: lr))
                im = torch.from_numpy(images).to(device)
                tk = torch.from_numpy(tokens).to(device)
                if kind == "plain":
                    step = contrastive.make_contrastive_train_step()
                    batches = list(zip(im, tk))
                else:
                    step = contrastive.make_accum_contrastive_train_step()
                    batches = [(im, tk)] * 2
                losses = [float(step(state, x, t)[1]["loss"])
                          for x, t in batches]
                r[kind] = (losses, {k: v.cpu() for k, v in
                                    model.module.state_dict().items()})
            model = create_model(tiny, seed=0, device=device,
                                 master_weights=True)
            r["eval"] = contrastive.evaluate_contrastive(
                model.module, [(images[i], captions[4 * i:4 * i + 4])
                               for i in range(2)], tokenizer)
            seen = {}
            inner = driver.evaluate_contrastive

            def recording(*args, **kw):
                seen.update(inner(*args, **kw))
                return seen
            driver.evaluate_contrastive = recording
            try:
                driver.main(["--model", tiny, "--val-data", val,
                             "--batch-size", "4", "--zeroshot-frequency",
                             "0", "--workers", "1", "--logs",
                             os.path.join(workdir, "tiny_leaf_val"),
                             "--name", device, "--device", device])
            finally:
                driver.evaluate_contrastive = inner
            r["leaf_val"] = seen
            runs[device] = r
    cpu, card = runs["cpu"], runs["cuda"]
    worst = {}
    for kind in ("plain", "accum"):
        (cl, cp), (gl, gp) = cpu[kind], card[kind]
        require(np.allclose(gl, cl, rtol=1e-4, atol=1e-6),
                f"(n) {kind} losses: card {gl}, CPU {cl}")
        # the attention's key bias has a zero true gradient: held to 2 lr a
        # step (ROADMAP Queue 3)
        diff = {k: (gp[k] - cp[k]).abs() for k in cp}
        key_bias = max(float(d[d.shape[0] // 3:2 * d.shape[0] // 3].max())
                       for k, d in diff.items() if k.endswith("attn.qkv_b"))
        for k, d in diff.items():
            if k.endswith("attn.qkv_b"):
                d[d.shape[0] // 3:2 * d.shape[0] // 3] = 0
        worst[kind] = max(float(d.max()) for d in diff.values())
        require(worst[kind] <= 1e-4 and key_bias <= 2 * 2 * lr,
                f"(n) {kind}: parameters differ by {worst[kind]}, the key "
                f"bias by {key_bias}")
    for part in ("eval", "leaf_val"):
        a, b = cpu[part], card[part]
        require(sorted(a) == sorted(b) and b["num_samples"] == 8
                and all(np.isclose(b[k], a[k], rtol=1e-4, atol=1e-6)
                        for k in a),
                f"(n) {part} metrics: card {b}, CPU {a}")
    say(f"(n) contrastive parity, ViT-tiny-test fp32, TF32 off, card vs CPU: "
        f"2 plain steps, losses {card['plain'][0]} (CPU {cpu['plain'][0]}), "
        f"parameters within {worst['plain']:.3g}; 2 feature-cache steps "
        f"(k = 2), losses {card['accum'][0]}, parameters within "
        f"{worst['accum']:.3g}; evaluate_contrastive {card['eval']} on both; "
        f"the LEAF driver's --val-data clip_val_loss "
        f"{card['leaf_val']['clip_val_loss']:.6g} (CPU "
        f"{cpu['leaf_val']['clip_val_loss']:.6g})")
    return {"plain_param_err": worst["plain"],
            "accum_param_err": worst["accum"],
            "eval": card["eval"], "leaf_val": card["leaf_val"]}


def _device_steps(n: int = 3):
    """The plain step at ViT-B-32, batch 256, with its batch already on the
    card: 1 warm-up step, then `n` timed by CUDA events, each held to its
    launches."""
    import torch
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train.contrastive import (
        ContrastiveState, make_contrastive_train_step)
    from leaf_tpu_torch.train.optim import make_optimizer

    model = create_model(CLIP_MODEL, precision="bf16", seed=0, device="cuda",
                         master_weights=True)
    module = model.module
    module.visual.compute_dtype = torch.bfloat16
    state = ContrastiveState(module, make_optimizer(
        module.named_parameters(), lambda step: 5e-4, weight_decay=0.2))
    g = torch.Generator(device="cuda").manual_seed(0)
    size = model.cfg.vision.image_size
    images = torch.randn(CLIP_BATCH, size, size, 3, generator=g,
                         device="cuda")
    tokens = torch.from_numpy(np.asarray(get_tokenizer(CLIP_MODEL)(
        _captions(np.random.default_rng(42), CLIP_BATCH, 3, 30)))).cuda()
    step = make_contrastive_train_step()
    counters = _Counters()
    step(state, images, tokens)
    torch.cuda.synchronize()
    want = _clip_launches(model.cfg, 1)
    seconds = []
    for _ in range(n):
        counters.zero()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, images, tokens)
        end.record()
        end.synchronize()
        got = {k: op.launches for k, op in counters.ops.items()}
        require(got == want, f"(n) device step: launches {got}, {want} "
                "expected")
        seconds.append(start.elapsed_time(end) / 1e3)
    say(f"(n) plain step, batch already on the card: "
        f"{[round(t, 4) for t in seconds]} s on the device, "
        f"{CLIP_BATCH / float(np.mean(seconds)):.1f} samples/s; launches "
        f"{want} a step")
    del model, module, state, images, tokens
    torch.cuda.empty_cache()
    return seconds


def phase_contrastive(workdir: str):
    """`contrastive_driver.main` at ViT-B-32's full width and depth (random
    weights, seed 0; bf16 on fp32 master weights; batch 256) on 2,048
    seeded image-caption pairs in 8 tar shards: 8 plain steps with
    `--val-data` (one more shard) before and after, a resume for 2 more,
    then 4 steps each with `--siglip`, `--accum-freq 2`, `--distill-model
    ViT-B-32` and `--lock-image`.  Per step: the device's seconds, the
    loader's wait, samples/s, launches held; per cell the peak memory."""
    import torch
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.train import contrastive_driver as cd

    cfg = get_model_config(CLIP_MODEL)
    rng = np.random.default_rng(43)
    t0 = time.perf_counter()
    train = _write_pair_tars(os.path.join(workdir, "clip_train"), rng,
                             CLIP_SHARDS, CLIP_PER_SHARD)
    val = _write_pair_tars(os.path.join(workdir, "clip_val"), rng, 1,
                           CLIP_PER_SHARD)
    say(f"(n) {CLIP_SHARDS * CLIP_PER_SHARD + CLIP_PER_SHARD} seeded 256 x "
        f"256 image-caption pairs written in {time.perf_counter() - t0:.1f} s")
    device_steps = _device_steps()
    logs = os.path.join(workdir, "clip_logs")
    base = CLIP_FLAGS + ["--train-data", train, "--logs", logs]
    pairs = CLIP_SHARDS * CLIP_PER_SHARD
    cells = [("plain", ["--val-data", val, "--train-num-samples",
                        str(pairs), "--epochs", "1"], 8, 1),
             ("resumed", ["--val-data", val, "--train-num-samples", "512",
                          "--epochs", "2", "--resume", "latest"], 2, 1),
             ("siglip", ["--siglip", "--train-num-samples", "1024",
                         "--epochs", "1"], 4, 1),
             ("accum 2", ["--accum-freq", "2", "--train-num-samples",
                          str(pairs), "--epochs", "1"], 4, 4),
             ("distill", ["--distill-model", CLIP_MODEL,
                          "--train-num-samples", "1024", "--epochs", "1"],
              4, 2),
             ("lock-image", ["--lock-image", "--train-num-samples", "1024",
                             "--epochs", "1"], 4, 1)]
    counters = _Counters()
    total = dict.fromkeys(counters.NAMES, 0)
    results = {"device_steps_s": device_steps}
    for tag, extra, n_steps, encodes in cells:
        name = "plain" if tag == "resumed" else tag.replace(" ", "_")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        counters.zero()
        t0 = time.perf_counter()
        with _ContrastiveRun(counters) as run:
            out = cd.main(base + extra + ["--name", name])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = max(run.peaks)
        accum = 2 if tag == "accum 2" else 1
        samples = CLIP_BATCH * accum
        want = _clip_launches(cfg, encodes)
        losses = [float(v) for v in run.losses]
        times = [t for t in out["times"]]
        require(len(run.steps) == len(times) == len(losses) == n_steps
                == len(run.sps),
                f"(n) {tag}: {len(run.steps)} steps, {len(times)} times, "
                f"{n_steps} expected")
        require(all(np.isfinite(v) and v > 0 for v in losses),
                f"(n) {tag}: losses {losses}")
        steps = []
        for i, (t, got, sps, gib) in enumerate(zip(times, run.steps, run.sps,
                                                    run.peaks)):
            require(got == want, f"(n) {tag} step {i + 1}: launches {got}, "
                    f"{want} expected ({encodes} passes of both towers)")
            steps.append(dict(t, samples_per_s=sps,
                              device_samples_per_s=samples / t["device_s"],
                              peak_gib=gib, launches=got))
            say(f"(n) {tag} step {i + 1}: {t['device_s']:.4f} s on the "
                f"device ({samples / t['device_s']:.1f} samples/s), the "
                f"loader kept the host waiting {t['wait_s']:.4f} s, the "
                f"loop's {sps:.1f} samples/s; peak {gib:.2f} GiB; launches "
                f"{got}")
        evals = []
        for got, metrics in run.evals:
            batches = -(-metrics["num_samples"] // CLIP_BATCH)
            want_eval = _clip_launches(cfg, batches)
            require(got == want_eval, f"(n) {tag} val eval: launches {got}, "
                    f"{want_eval} expected ({batches} batches)")
            n = metrics["num_samples"]
            require(n == CLIP_PER_SHARD
                    and all(0 <= v <= 1 for k, v in metrics.items()
                            if "_R@" in k)
                    and all(1 <= v <= n for k, v in metrics.items()
                            if k.endswith("_rank"))
                    and np.isfinite(metrics["clip_val_loss"]),
                    f"(n) {tag} val metrics: {metrics}")
            evals.append(metrics)
        launched = {k: op.launches for k, op in counters.ops.items()}
        counted = {k: sum(s[k] for s in run.steps)
                   + sum(g[k] for g, _ in run.evals) for k in launched}
        require(launched == counted,
                f"(n) {tag}: launches {launched} outside the steps and "
                f"evals ({counted})")
        for k in total:
            total[k] += launched[k]
        rows = out["results"]
        extra_say = ""
        if tag == "resumed":
            require(out["state"].step == 10 and [
                str(r["epoch"]) for r in rows] == ["0", "1", "2"],
                f"(n) resume: step {out['state'].step}, rows {rows}")
            extra_say = ", resumed at step 8 to step 10"
        if tag == "lock-image":
            init = create_model(CLIP_MODEL, seed=0, device="cpu",
                                master_weights=True).module.visual
            final = out["model"].module.visual.state_dict()
            require(all(torch.equal(v, final[k].cpu())
                        for k, v in init.state_dict().items()),
                    "(n) --lock-image: the vision tower moved")
            extra_say = ", the vision tower unchanged bit for bit"
            del init, final
        if evals:
            extra_say += (f"; val metrics {[{k: round(v, 4) for k, v in m.items()} for m in evals]}")
        say(f"(n) {tag}: {n_steps} steps in {seconds:.1f} s (model build, "
            f"evals and checkpoint included), losses "
            f"{[round(v, 4) for v in losses]}, peak device memory of a step "
            f"{peak:.2f} GiB{extra_say}")
        results[tag] = {"seconds": seconds, "steps": steps,
                        "losses": losses, "peak_gib": peak, "val": evals}
        if tag != "plain":
            shutil.rmtree(os.path.join(logs, name), ignore_errors=True)
        del out, run
        torch.cuda.empty_cache()
    return total, results


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# (o) the benchmark suite and PEZ
# ---------------------------------------------------------------------------

BENCH_BATCH = 64          # the benchmark command line's default batch
CIFAR_IMAGES, APGD_IMAGES = 1024, 32
PEZ_ITERS, PEZ_IMAGE_ITERS = 300, 100   # the command line's default: 3,000


def _write_cifar(root: str, rng, n: int) -> str:
    """A CIFAR-10 python-pickle layout of `n` seeded 32 x 32 images."""
    import pickle
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                     b"labels": [int(x) for x in rng.integers(0, 10, n)]}, f)
    with open(os.path.join(d, "batches.meta"), "wb") as f:
        pickle.dump({b"label_names": [
            n.encode() for n in ("airplane automobile bird cat deer dog frog "
                                 "horse ship truck").split()]}, f)
    return root


def _write_bench_sets(root: str, rng, n_images: int, size: int,
                      probe=(256, 64), classes: int = 8):
    """The non-CIFAR layouts of (o), seeded `.npy` images: a WordNet-id
    folder (imagenet1k's first `classes` classes), a Karpathy retrieval JSON
    (5 captions an image), a SugarCrepe JSON (`add_att`) and linear-probe
    train/test folders.  Returns their roots."""
    from leaf_tpu_torch.benchmark.builder import load_imagenet_wnids

    def image(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, rng.integers(0, 256, (size, size, 3), dtype=np.uint8))

    wnids = load_imagenet_wnids()["all"][:classes]
    for i in range(n_images):
        image(os.path.join(root, "imagenet", wnids[i % classes], f"{i}.npy"))
    ann, sugar = [], {}
    for i in range(n_images):
        image(os.path.join(root, "coco", f"{i:04d}.npy"))
        ann.append({"image": f"{i:04d}.npy",
                    "caption": [c.capitalize() + "." for c in
                                _captions(rng, 5, 5, 14)]})
        image(os.path.join(root, "sugar", "images", f"{i:04d}.npy"))
        pos, neg = _captions(rng, 2, 4, 12)
        sugar[str(i)] = {"filename": f"{i:04d}.npy", "caption": pos,
                         "negative_caption": neg}
    with open(os.path.join(root, "coco", "karpathy.json"), "w") as f:
        json.dump(ann, f)
    with open(os.path.join(root, "sugar", "add_att.json"), "w") as f:
        json.dump(sugar, f)
    for split, n in zip(("train", "test"), probe):
        for i in range(n):
            image(os.path.join(root, "probe", split, f"class_{i % classes}",
                               f"{i:04d}.npy"))
    return {name: os.path.join(root, name)
            for name in ("imagenet", "coco", "sugar", "probe")}


def _bench_flags(sets, cifar, cifar_apgd):
    """Each benchmark part's `cli eval` flags (model, device and output
    left out)."""
    return {
        "cifar10 fp32": ["--dataset", "cifar10", "--dataset-root", cifar],
        "imagenet1k wnid folder fp32": [
            "--dataset", "imagenet1k", "--dataset-root", sets["imagenet"]],
        "cifar10 bf16": ["--dataset", "cifar10", "--dataset-root", cifar,
                         "--precision", "bf16"],
        "cifar10 apgd": ["--dataset", "cifar10", "--dataset-root",
                         cifar_apgd, "--attack", "apgd", "--attack-iters",
                         None],
        "retrieval": ["--dataset", "mscoco_captions", "--dataset-root",
                      sets["coco"], "--annotation-file",
                      os.path.join(sets["coco"], "karpathy.json")],
        "sugar_crepe": ["--dataset", "sugar_crepe/add_att",
                        "--dataset-root", sets["sugar"]],
        "linear_probe": ["--dataset", "probe", "--dataset-root",
                         sets["probe"], "--task", "linear_probe"],
        "linear_probe fewshot 8": [
            "--dataset", "probe", "--dataset-root", sets["probe"], "--task",
            "linear_probe", "--fewshot-k", "8"],
    }


def phase_benchmark_parity(workdir: str):
    """ViT-tiny-test, fp32, TF32 off, the card against the CPU from the same
    seeded weights: `benchmark.cli eval` gives the same JSON metrics for
    zero-shot classification clean and with APGD (5 iterations), retrieval,
    caption selection and the linear probe (the same initial weight; its
    loss within 1e-4); 20 PEZ steps from the same initial ids choose the
    same ids at every step, with similarities within 1e-4."""
    import torch
    from leaf_tpu_torch.benchmark import cli
    from leaf_tpu_torch.evals.pez import optimize_prompt
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer

    tiny = "ViT-tiny-test"
    root = os.path.join(workdir, "bench_tiny")
    rng = np.random.default_rng(41)
    cifar = _write_cifar(os.path.join(root, "cifar"), rng, 12)
    sets = _write_bench_sets(root, rng, 6, 48, probe=(12, 6), classes=3)
    flags = _bench_flags(sets, cifar, cifar)
    flags["cifar10 apgd"][-1] = "5"
    del flags["cifar10 bf16"], flags["linear_probe fewshot 8"]
    out = {}
    for part, args in flags.items():
        res = {}
        for device in ("cpu", "cuda"):
            res[device] = cli.main(["eval", "--model", tiny, "--batch-size",
                                    "4", "--device", device] + args)[0]
        cpu, card = res["cpu"]["metrics"], res["cuda"]["metrics"]
        loss_gap = abs(cpu.pop("lp_train_loss", 0.0)
                       - card.pop("lp_train_loss", 0.0))
        require(cpu == card and loss_gap <= 1e-4,
                f"(o) tiny {part}: card {card} against CPU {cpu} (probe loss "
                f"gap {loss_gap})")
        say(f"(o) tiny {part}: card = CPU {card}"
            + (f", probe loss gap {loss_gap:.2e}" if "lp_acc1" in card
               else ""))
        out[part] = card

    tok = get_tokenizer(tiny)
    runs = {}
    for device in ("cpu", "cuda"):
        model = create_model(tiny, seed=0, device=device)
        with torch.no_grad():
            target = create_model(tiny, seed=0, device="cpu").module.text \
                .encode_text(torch.from_numpy(tok(["a red car near the old "
                                                   "river bank"])),
                             normalize=True)
        runs[device] = optimize_prompt(model.module.text, target,
                                       prompt_len=8, iters=20, seed=0)
    cpu, card = runs["cpu"], runs["cuda"]
    gap = float(np.max(np.abs(np.asarray(cpu["per_step_sims"])
                              - np.asarray(card["per_step_sims"]))))
    changes = sum(a != b for a, b in zip(card["per_step_ids"],
                                         card["per_step_ids"][1:]))
    require(card["per_step_ids"] == cpu["per_step_ids"] and gap <= 1e-4,
            f"(o) tiny PEZ: ids {card['per_step_ids']} against "
            f"{cpu['per_step_ids']}, sims gap {gap}")
    say(f"(o) tiny PEZ, 20 steps: the card chose the CPU's ids at every step "
        f"({changes} changes of the prompt), sims within {gap:.2e}, best "
        f"{card['sim']:.6f}")
    out["pez"] = {"sims_gap": gap, "prompt_changes": changes,
                  "best_sim": card["sim"]}
    return out


class _Encodes:
    """One part of (o): the kernels' counters zeroed and the device memory's
    peak reset just before; just after, the counters held to the text and
    image encodes the part made on the card (a fused block and its
    attention per layer, `ln_2` per layer + `ln_final` per text encode,
    `ln_pre` + `ln_2` per layer + `ln_post` per image encode), the encodes
    to the count the part implies where it is fixed, and a line with the
    part's seconds and peak memory.  Text encodes are counted at the text
    tail every text forward ends in (packed or from embeddings, as PEZ
    runs it), image encodes at `encode_image`."""

    def __init__(self, counters, tag: str, want_encodes=None,
                 layers=(12, 24), label: str = "(o)"):
        self.counters, self.tag, self.want = counters, tag, want_encodes
        self.layers, self.label = layers, label

    def __enter__(self):
        import torch
        from leaf_tpu_torch.models.clip import TextTower, VisionTower
        self.encodes = {"text": 0, "image": 0}
        part = self

        from torch._subclasses.fake_tensor import is_fake

        def counted(cls, name, kind):
            inner = getattr(cls, name)

            def wrapper(self, x, *args, **kwargs):
                # a `torch.export` trace runs the towers on fake tensors,
                # which launch nothing
                if x.is_cuda and not is_fake(x):
                    part.encodes[kind] += 1
                return inner(self, x, *args, **kwargs)
            setattr(cls, name, wrapper)
            return cls, name, inner

        self.saved = [counted(TextTower, "_text_tail", "text"),
                      counted(VisionTower, "encode_image", "image")]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.counters.zero()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        for cls, name, inner in self.saved:
            setattr(cls, name, inner)
        if exc_type is not None:
            return False
        t, i = self.encodes["text"], self.encodes["image"]
        lt, li = self.layers
        want = {"packed_attention": lt * t + li * i,
                "fused_attention_block": lt * t + li * i,
                "layer_norm": (lt + 1) * t + (li + 2) * i}
        self.launches = {n: op.launches for n, op in self.counters.ops.items()}
        self.peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"{self.label} {self.tag}: {self.seconds:.2f} s, peak device memory "
            f"{self.peak_gib:.1f} GiB; launches {self.launches}, {t} text + "
            f"{i} image encodes = {want}")
        if self.want is not None:
            require((t, i) == self.want, f"{self.label} {self.tag}: {t} text "
                    f"and {i} image encodes, {self.want} expected")
        for name in want:
            require(self.launches[name] == want[name],
                    f"{self.label} {self.tag}: {name} {self.launches[name]} "
                    f"launches, {want[name]} expected")
            self.counters.total[name] += self.launches[name]
        require(t + i > 0, f"{self.label} {self.tag}: no encode on the card")
        return False


def _in_unit(metrics: dict, keys) -> bool:
    return all(np.isfinite(metrics[k]) and 0.0 <= metrics[k] <= 1.0
               for k in keys if metrics.get(k) is not None)


def phase_benchmark(workdir: str):
    """`benchmark.cli` and the PEZ command lines at ViT-L-14-quickgelu's full
    width and depth (random weights, seed 0), each part's encodes and
    launches held: `cli eval` (fp32, batch 64, TF32 off) on a CIFAR-10
    pickle layout of 1,024 seeded 32 x 32 images (10 classes x 18
    templates), an imagenet1k WordNet-id folder of 8 classes with 64 `.npy`
    images (80 templates), the CIFAR set with `--precision bf16`, `--attack
    apgd --attack-iters 10` on 32 CIFAR images, a Karpathy retrieval JSON of
    64 images x 5 captions, a SugarCrepe JSON of 64 records, the linear
    probe on 8-class folders (256 / 64 images, 100 epochs) and with
    `--fewshot-k 8`; `build` and `reformat` over the JSONs; then
    `pez_driver.main` on 2 seeded captions (3-10 and 20-30 words, prompt
    length "match", 300 iterations where the default is 3,000), one image
    target of 2 `.npy` images (16 slots, 100 iterations), `pez_metrics.main`
    over the results, and 20 PEZ steps under `torch.profiler` (the device's
    idle share).  Each part prints its seconds by part (model build, the
    waits for the host's images, the device's encodes), images/s, peak
    memory and metrics (finite, in [0, 1], robust <= clean)."""
    import torch
    from leaf_tpu_torch.benchmark import cli
    from leaf_tpu_torch.evals import pez, pez_driver, pez_metrics
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.profile_serve import profile_cell

    root = os.path.join(workdir, "bench")
    rng = np.random.default_rng(43)
    t0 = time.perf_counter()
    cifar = _write_cifar(os.path.join(root, "cifar"), rng, CIFAR_IMAGES)
    cifar_apgd = _write_cifar(os.path.join(root, "cifar_apgd"), rng,
                              APGD_IMAGES)
    sets = _write_bench_sets(root, rng, BENCH_BATCH, 256)
    say(f"(o) wrote the benchmark's seeded layouts in "
        f"{time.perf_counter() - t0:.1f} s")
    flags = _bench_flags(sets, cifar, cifar_apgd)
    flags["cifar10 apgd"][-1] = "10"
    n_probe = (256 + 64) // BENCH_BATCH
    want = {"cifar10 fp32": (1, CIFAR_IMAGES // BENCH_BATCH),
            "imagenet1k wnid folder fp32": (1, 1),
            "cifar10 bf16": (1, CIFAR_IMAGES // BENCH_BATCH),
            "cifar10 apgd": None,
            "retrieval": (2, 1), "sugar_crepe": (1, 1),
            "linear_probe": (0, n_probe),
            "linear_probe fewshot 8": (0, n_probe)}
    images = {"cifar10 fp32": CIFAR_IMAGES,
              "imagenet1k wnid folder fp32": BENCH_BATCH,
              "cifar10 bf16": CIFAR_IMAGES, "cifar10 apgd": APGD_IMAGES,
              "retrieval": BENCH_BATCH, "sugar_crepe": BENCH_BATCH,
              "linear_probe": 320, "linear_probe fewshot 8": 320}
    counters, pez_counters, out, results = _Counters(), _Counters(), {}, []
    for part, args in flags.items():
        seconds = {}
        path = os.path.join(root, part.replace(" ", "_") + ".json")
        with _Encodes(counters, f"benchmark {part}", want[part]) as enc:
            res = cli.main(["eval", "--model", MODEL, "--device", "cuda",
                            "--output", path] + args, seconds=seconds)[0]
        m = res["metrics"]
        require(_in_unit(m, [k for k in m if k.startswith(
                    ("acc", "mean_", "image_", "text_", "lp_acc",
                     "lp_mean", "robust"))]),
                f"(o) {part}: metrics out of range: {m}")
        if "robust_acc1" in m:
            require(m["robust_acc1"] <= m["acc1"], f"(o) {part}: {m}")
        device_s = sum(v for k, v in seconds.items()
                       if k not in ("build", "data"))
        rate = images[part] / max(enc.seconds - seconds.get("build", 0.0),
                                  1e-9)
        waits = seconds.get("data", 0.0)
        say(f"(o) {part}: seconds by part "
            f"{ {k: round(v, 2) for k, v in seconds.items()} }; "
            f"{images[part]} images, {rate:.1f} images/s after the build, "
            f"host waits {waits / max(waits + device_s, 1e-9):.2f} of the "
            f"data + device time; metrics {m}")
        out[part] = {"seconds": enc.seconds, "part_seconds": seconds,
                     "images": images[part], "images_per_s": rate,
                     "peak_gib": enc.peak_gib, "launches": enc.launches,
                     "metrics": m}
        results.append(path)
    t0 = time.perf_counter()
    cli.main(["build", *results, "--output", os.path.join(root, "b.csv")])
    table = cli.main(["reformat", os.path.join(root, "b.csv"), "--output",
                      os.path.join(root, "p.csv")])
    # one row of clean top-1 (fp32 and bf16 averaged: the result files do
    # not say their precision) and one under APGD
    require(len(table) == 3, f"(o) reformat: {table}")
    say(f"(o) build + reformat over {len(results)} JSONs: "
        f"{time.perf_counter() - t0:.2f} s, {len(table) - 1} table rows")

    captions = os.path.join(root, "captions.txt")
    with open(captions, "w") as f:
        f.write("\n".join(_captions(rng, 1, 3, 10) + _captions(rng, 1, 20, 30))
                + "\n")
    pez_out = os.path.join(root, "pez")
    inner, clock = pez.optimize_prompt, {"s": 0.0, "iters": 0}

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            clock["s"] += time.perf_counter() - t0
            clock["iters"] += kwargs["iters"]

    pez.optimize_prompt = timed
    try:
        for tag, args, encodes in (
                ("captions", ["--captions", captions, "--iter",
                              str(PEZ_ITERS)], (2 * (1 + PEZ_ITERS), 0)),
                ("image target", ["--images"] + [
                    os.path.join(sets["coco"], f"000{i}.npy")
                    for i in range(2)] + ["--prompt-len", "16", "--iter",
                                          str(PEZ_IMAGE_ITERS)],
                 (PEZ_IMAGE_ITERS, 1))):
            clock.update(s=0.0, iters=0)
            with _Encodes(pez_counters, f"pez {tag}", encodes) as enc:
                payload = pez_driver.main(
                    ["--model", MODEL, "--device", "cuda", "--output",
                     os.path.join(pez_out, tag.split()[0])] + args)
            sims = [r["cosine_sim"] for r in payload["results"]]
            require(all(np.isfinite(x) and -1.0 <= x <= 1.0 for x in sims),
                    f"(o) pez {tag}: {sims}")
            per_it = clock["s"] / clock["iters"]
            say(f"(o) pez {tag}: {clock['iters']} iterations in "
                f"{clock['s']:.2f} s, {per_it * 1e3:.2f} ms an iteration "
                f"({1 / per_it:.1f}/s); {enc.seconds - clock['s']:.2f} s "
                f"outside the loop; sims {sims}, prompt lengths "
                f"{[r['prompt_len'] for r in payload['results']]}")
            out[f"pez {tag}"] = {"seconds": enc.seconds, "loop_s": clock["s"],
                                 "iterations": clock["iters"],
                                 "s_per_iteration": per_it,
                                 "peak_gib": enc.peak_gib,
                                 "launches": enc.launches, "sims": sims}
    finally:
        pez.optimize_prompt = inner
    # the metrics are defined for caption inversions alone
    metrics = pez_metrics.main([os.path.join(pez_out, "captions")])
    cap = next(iter(metrics.values()))
    require(_in_unit(cap, ["word_accuracy", "token_accuracy"]),
            f"(o) pez_metrics: {metrics}")
    out["pez metrics"] = cap

    model = create_model(MODEL, seed=0, device="cuda")
    text = model.module.text
    target = torch.nn.functional.normalize(
        torch.randn(1, text.cfg.output_dim, device="cuda"), dim=-1)
    prof = profile_cell("(o) 20 PEZ steps at ViT-L-14 (text [1, 77, 768] "
                        "fp32)", lambda: pez.optimize_prompt(
                            text, target, prompt_len=16, iters=20),
                        batches=1, warm=1, profiled=1)
    say(f"(o) PEZ under the profiler: {prof['ms_per_batch'] / 20:.2f} ms a "
        f"step, device busy {prof['busy_ms_per_batch'] / 20:.2f} ms a step, "
        f"idle share {prof['idle_share']:.3f}, "
        f"{prof['device_events_per_batch'] / 20:.0f} device events a step")
    out["pez profile"] = prof
    return counters.total, pez_counters.total, out


# ---------------------------------------------------------------------------
# (p) CLIPScore, FID, text to image, HF checkpoints, int8, export, profiler
# ---------------------------------------------------------------------------

def _tiny_sd_components(t2i, tok):
    """Tiny random-weight SD components (a conv noise predictor that reads
    the latents, the timestep and the text embedding; an embedding table as
    text encoder; a transposed conv as VAE decoder), the same weights each
    call, moved to the latents' device."""
    import torch

    class UNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.conv = torch.nn.Conv2d(4, 4, 3, padding=1)
            self.emb_proj = torch.nn.Linear(16, 4)

        def forward(self, x, t, emb):
            e = self.emb_proj(emb.mean(dim=1))[:, :, None, None]
            return self.conv(x) + e + 0.001 * float(t) * torch.tanh(x)

    torch.manual_seed(1)
    text_emb = torch.nn.Embedding(49408, 16)
    unet = UNet()
    decode = torch.nn.ConvTranspose2d(4, 3, 4, stride=4)
    with torch.no_grad():
        return t2i.SDComponents(
            tokenize=lambda caps: torch.from_numpy(np.asarray(tok(caps))).long(),
            text_encoder=lambda ids: text_emb.to(ids.device)(ids).detach(),
            unet=lambda x, t, emb: unet.to(x.device)(x, t, emb).detach(),
            vae_decode=lambda z: torch.tanh(decode.to(z.device)(z)).detach(),
            latent_channels=4, image_size=64, vae_factor=4)


def _rel_close(a: dict, b: dict, tol: float) -> float:
    """Largest difference between two metric dicts, relative to each value's
    size where it exceeds 1; fails past `tol` or on other keys."""
    require(a.keys() == b.keys(), f"keys {sorted(a)} != {sorted(b)}")
    worst = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for k in a)
    require(worst <= tol, f"{a} vs {b}: {worst} > {tol}")
    return worst


def phase_t2i_parity(workdir: str):
    """(p) at ViT-tiny-test, fp32, TF32 off, the card against the CPU from
    the same seeded weights: CLIPScore and CLIP-FID, `generate_images` with
    tiny components (DDIM and PLMS), int8 MLP features, the HF round trip
    (1e-5 each); the export traced on the card holds the custom ops and
    gives the eager features; and the custom-op route's wrapper time at
    (c)'s small shapes against the direct call."""
    import torch
    from leaf_tpu_torch.evals import clipscore
    from leaf_tpu_torch.evals import text_to_image as t2i
    from leaf_tpu_torch.models import export, interop
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.ops import packed_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = "ViT-tiny-test"
    tok = get_tokenizer(tiny)
    rng = np.random.default_rng(60)
    out = {}
    models = {dev: create_model(tiny, seed=0, device=dev)
              for dev in ("cpu", "cuda")}

    caps = _captions(rng, 12, 3, 12)
    gen = rng.uniform(0, 1, (12, 64, 64, 3)).astype(np.float32)
    gen[[2, 7]] *= 0.01                                  # two blanked
    real = rng.uniform(0, 1, (12, 64, 64, 3)).astype(np.float32)
    res = {dev: clipscore.compute_clipscores_and_fid(
        m, tok, caps, gen, real, batch_size=4) for dev, m in models.items()}
    require(res["cuda"]["n_black_filtered"] == 2, f"{res['cuda']}")
    out["clipscore_fid"] = _rel_close(res["cuda"], res["cpu"], 1e-5)
    say(f"(p) CLIPScore + CLIP-FID card vs CPU: {res['cuda']}, largest "
        f"difference {out['clipscore_fid']:.3g}")

    for sched in ("ddim", "pndm"):
        imgs = {}
        for dev in ("cpu", "cuda"):
            comps = _tiny_sd_components(t2i, tok)
            comps.scheduler = sched
            imgs[dev] = t2i.generate_images(caps[:3], components=comps,
                                            num_inference_steps=6, seed=3,
                                            device=dev)
        err = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
        require(imgs["cuda"].shape == (3, 64, 64, 3) and err <= 1e-5,
                f"generate_images {sched}: max abs {err}")
        out[f"generate_{sched}"] = err
        say(f"(p) generate_images {sched}, 6 steps, card vs CPU: max abs "
            f"{err:.3g}")

    tokens = np.stack([tok(caps[:8])[:, :16], tok(caps[4:12])[:, :16]])
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    feats = {}
    for dev in ("cpu", "cuda"):
        m = create_model(tiny, seed=0, device=dev, int8_mlp=True)
        feats[dev] = _features(m, tokens[0], images)
    err = float(np.abs(feats["cuda"] - feats["cpu"]).max())
    require(err <= 1e-5, f"int8 features: max abs {err}")
    out["int8"] = err
    say(f"(p) int8 MLP features card vs CPU: max abs {err:.3g}")

    card = models["cuda"]
    back = create_model(tiny, seed=1, device="cuda")
    hf = interop.params_to_hf(card.module.state_dict(), card.cfg)
    back.module.load_state_dict(interop.hf_to_params(hf, card.cfg))
    err = max(float(np.abs(_features(back, tokens[0], images)
                           - _features(card, tokens[0], images)).max()),
              float(np.abs(_features(back, tokens[0], images)
                           - _features(models["cpu"], tokens[0],
                                       images)).max()))
    require(err <= 1e-5, f"HF round trip: max abs {err}")
    out["hf_round_trip"] = err
    say(f"(p) HF round trip on the card: max abs {err:.3g} (against the card "
        "and the CPU)")

    text_ep, image_ep = export.trace_model(card, batch_size=4, normalize=True)
    nodes = {}
    for name, ep in (("text", text_ep), ("image", image_ep)):
        for n in ep.graph.nodes:
            if n.op == "call_function" and "leaf_tpu_torch" in str(n.target):
                key = f"{name} {n.target}"
                nodes[key] = nodes.get(key, 0) + 1
    layers = card.cfg.text.layers
    require(nodes.get("text leaf_tpu_torch.fused_attention_block.default")
            == layers and nodes.get(
                "image leaf_tpu_torch.fused_attention_block.default")
            == card.cfg.vision.layers, f"exported graph: {nodes}")
    toks77 = torch.from_numpy(tok(caps[:4])).to("cuda")
    imgs_d = torch.from_numpy(images).to("cuda")
    with torch.inference_mode():
        err = max(float((text_ep.module()(toks77)
                         - card.module.encode_text(toks77, True)).abs().max()),
                  float((image_ep.module()(imgs_d)
                         - card.module.encode_image(imgs_d, True)).abs().max()))
    require(err <= 1e-6, f"exported features differ from eager: {err}")
    out["export"] = {"max_abs": err, "nodes": nodes}
    say(f"(p) export on the card: custom-op nodes {nodes}; exported vs eager "
        f"features max abs {err:.3g}")

    # the custom-op route's host cost at (c)'s small shapes (PEZ's LayerNorm
    # and packed row): wrapper times, direct call against the dispatcher
    x = torch.randn(77, 768, device="cuda")
    w, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    qkv = torch.randn(1, 77, 3 * 768, device="cuda")
    route = {}
    for name, fn in (("layer_norm 77x768 fp32",
                      lambda: pa.layer_norm(x, w, b)),
                     ("packed_attention [1, 77, 768] fp32 causal",
                      lambda: pa.packed_attention(qkv, 12, 77, True))):
        direct = _time_ms(fn, 200)
        with pa.dispatcher():
            routed = _time_ms(fn, 200)
        direct2 = _time_ms(fn, 200)
        route[name] = {"direct_ms": min(direct, direct2),
                       "custom_op_ms": routed}
        say(f"(p) {name}: direct wrapper {min(direct, direct2):.4f} ms, "
            f"through the custom op {routed:.4f} ms a call")
    out["custom_op_route"] = route
    return out


class _ServeLog(logging.Handler):
    """Keeps serve's rate and int8 lines."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def last(self, prefix: str) -> str:
        return next(m for m in reversed(self.lines) if m.startswith(prefix))


def phase_t2i_tooling(workdir: str):
    """(p) at ViT-L-14-quickgelu's full width and depth (random weights):
    `convert.main` OpenCLIP -> HF -> OpenCLIP with `--verify` on the card
    and `push_to_hf_hub.main --local-dir-only`; `clipscore.main` on 256
    generated (16 black) and 256 real 224 x 224 `.npy` images with CLIP-FID,
    then again from the HF directory under the GELU name (the checkpoint's
    QuickGELU adopted); `text_to_image.main` stage 1 on 64 captions (rho 10,
    k 2, fp32) and the dual-encoder mode on 8 (the second tower from seed
    1); `serve.main --int8-mlp` (bf16, buckets 16 and 77, 128 images)
    against the unquantized runs, and `--export`, its artifacts run on the
    card; `utils.profiler.main` on the card against the CPU count; and
    `train.driver.main` for 8 steps with `--profile-dir`, `--remote-sync`,
    `--copy-codebase` and `--matmul-precision highest`.  Each encoding part
    holds the kernels' launches to its encodes."""
    import torch
    from leaf_tpu_torch import convert, push_to_hf_hub, serve
    from leaf_tpu_torch.evals import clipscore
    from leaf_tpu_torch.evals import text_to_image as t2i
    from leaf_tpu_torch.models import export, interop
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.models.preprocess import image_transform
    from leaf_tpu_torch.train import driver
    from leaf_tpu_torch.utils import profiler

    root = os.path.join(workdir, "p")
    os.makedirs(root)
    rng = np.random.default_rng(61)
    counters = {k: _Counters() for k in ("clipscore", "t2i_attack",
                                         "serve_int8", "export")}
    out = {}

    def gb(path):
        return os.path.getsize(path) / 1e9

    # ---- convert and push_to_hf_hub ----------------------------------------
    files = {}
    for seed in (0, 1):
        t0 = time.perf_counter()
        m = create_model(MODEL, seed=seed, device="cpu")
        files[seed] = convert.save_state_dict(
            convert.params_to_openclip(m.module.state_dict(), m.cfg),
            os.path.join(root, f"openclip_seed{seed}"))
        del m
        say(f"(p) seeded OpenCLIP file, seed {seed}: {gb(files[seed]):.2f} GB "
            f"in {time.perf_counter() - t0:.1f} s (init + write)")
    hf_dir, back_dir = os.path.join(root, "hf"), os.path.join(root, "back")
    conv = {}
    for name, argv, made in (
            ("to hf", ["--input", files[0], "--output", hf_dir, "--to", "hf"],
             os.path.join(hf_dir, "model.safetensors")),
            ("to openclip", ["--input", hf_dir, "--output", back_dir, "--to",
                             "openclip"],
             os.path.join(back_dir, "open_clip_model.safetensors"))):
        t0 = time.perf_counter()
        convert.main(["--model", MODEL, "--verify", "--device", DEVICE] + argv)
        conv[name] = {"seconds": time.perf_counter() - t0, "gb": gb(made)}
        say(f"(p) convert {name} --verify (1e-4, on the card): "
            f"{conv[name]['seconds']:.1f} s, wrote {conv[name]['gb']:.2f} GB")
    a = interop.load_state_dict_file(files[0])
    b = interop.load_state_dict_file(
        os.path.join(back_dir, "open_clip_model.safetensors"))
    require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
            "OpenCLIP -> HF -> OpenCLIP is not exact")
    del a, b
    with open(os.path.join(hf_dir, "config.json")) as f:
        require(json.load(f)["text_config"]["hidden_act"] == "quick_gelu",
                "the HF config does not declare QuickGELU")
    t0 = time.perf_counter()
    hub = push_to_hf_hub.main(["--model", MODEL, "--input", back_dir,
                               "--repo-id", "leaf/vit-l-14-quickgelu-seed0",
                               "--local-dir", os.path.join(root, "hub"),
                               "--local-dir-only"])
    conv["push_to_hf_hub"] = {"seconds": time.perf_counter() - t0,
                              "files": sorted(os.listdir(hub))}
    require(conv["push_to_hf_hub"]["files"] == [
        "README.md", "open_clip_config.json", "open_clip_model.safetensors"],
        f"hub layout {conv['push_to_hf_hub']['files']}")
    say(f"(p) push_to_hf_hub --local-dir-only: "
        f"{conv['push_to_hf_hub']['seconds']:.1f} s, {conv['push_to_hf_hub']}")
    shutil.rmtree(hub)
    shutil.rmtree(back_dir)
    out["convert"] = conv

    # ---- CLIPScore and CLIP-FID --------------------------------------------
    n_img, n_black, size = 256, 16, 224
    caps = _captions(rng, n_img, 3, 12)
    for kind in ("gen", "real"):
        os.makedirs(os.path.join(root, kind))
        for i in range(n_img):
            img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            if kind == "gen" and i % (n_img // n_black) == 0:
                img[:] = rng.integers(0, 3, (size, size, 3), dtype=np.uint8)
            np.save(os.path.join(root, kind, f"{i:05d}.npy"), img)
    cap_file = os.path.join(root, "captions.json")
    with open(cap_file, "w") as f:
        json.dump(caps, f)
    kept = n_img - n_black
    want = (-(-kept // 64), 4 * -(-kept // 64))
    scores = {}
    for name, flags in (
            ("random weights", ["--model", MODEL, "--allow-random-weights"]),
            ("HF dir, GELU name", ["--model", MODEL.replace("-quickgelu", ""),
                                   "--pretrained", hf_dir])):
        with _Encodes(counters["clipscore"], f"clipscore {name}", want,
                      label="(p)") as enc:
            res = clipscore.main(flags + [
                "--gen-dir", os.path.join(root, "gen"), "--real-dir",
                os.path.join(root, "real"), "--captions", cap_file,
                "--fid-features", "clip", "--batch-size", "64", "--device",
                DEVICE])
        require(res["n"] == kept and res["n_black_filtered"] == n_black,
                f"clipscore: {res}")
        require(all(np.isfinite(v) for v in res.values()), f"{res}")
        scores[name] = {"result": res, "seconds": enc.seconds,
                        "images_per_s": 2 * n_img / enc.seconds,
                        "launches": enc.launches}
        say(f"(p) clipscore.main {name}: {res}; {enc.seconds:.1f} s, "
            f"{2 * n_img / enc.seconds:.1f} images/s (both folders, model "
            "build included)")
    diff = _rel_close(scores["HF dir, GELU name"]["result"],
                      scores["random weights"]["result"], 1e-5)
    say(f"(p) the HF directory under the GELU name adopted QuickGELU: the same "
        f"scores as the seeded ViT-L-14-quickgelu (largest difference "
        f"{diff:.3g})")
    out["clipscore"] = scores
    shutil.rmtree(hf_dir)

    # ---- text to image, stage 1 -------------------------------------------
    t2i_caps = _captions(rng, 64, 3, 12)
    runs = {}
    for name, caps_n, extra in (
            ("single", t2i_caps, []),
            ("dual", t2i_caps[:8], ["--model2", MODEL, "--pretrained2",
                                    files[1]])):
        cf = os.path.join(root, f"t2i_{name}.json")
        with open(cf, "w") as f:
            json.dump(caps_n, f)
        with _Encodes(counters["t2i_attack"], f"text_to_image {name}",
                      label="(p)") as enc:
            adv = t2i.main(["--model", MODEL, "--captions", cf, "--rho", "10",
                            "--k", "2", "--output-dir",
                            os.path.join(root, f"t2i_{name}"), "--device",
                            DEVICE] + extra)
        changed = sum(a != c for a, c in zip(adv, caps_n))
        require(len(adv) == len(caps_n) and changed > 0,
                f"t2i {name}: {changed} of {len(adv)} captions changed")
        runs[name] = {"captions": len(caps_n), "changed": changed,
                      "seconds": enc.seconds,
                      "captions_per_s": len(caps_n) / enc.seconds,
                      "encodes": enc.encodes, "launches": enc.launches}
        say(f"(p) text_to_image.main {name} (rho 10, k 2, fp32): "
            f"{len(caps_n)} captions, {changed} changed, {enc.seconds:.1f} s, "
            f"{len(caps_n) / enc.seconds:.2f} captions/s (model builds "
            f"included), {enc.encodes['text']} text encodes")
    out["text_to_image"] = runs
    os.remove(files[1])

    # ---- serve --int8-mlp and --export -------------------------------------
    sets = {"s16": _captions(rng, 2048, 3, 10),
            "s77": _captions(rng, 512, 80, 90)}
    img_dir = os.path.join(root, "serve_images")
    os.makedirs(img_dir)
    for i in range(128):
        np.save(os.path.join(img_dir, f"{i:04d}.npy"),
                rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
    handler = _ServeLog()
    log = logging.getLogger("leaf_tpu_torch.serve")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    serve_out, feats = {}, {}
    export_dir = os.path.join(root, "export")
    try:
        for int8 in (True, False):
            for name, caps_n in sets.items():
                path = os.path.join(root, f"{name}.txt")
                with open(path, "w") as f:
                    f.write("\n".join(caps_n) + "\n")
                argv = ["--model", MODEL, "--texts", path, "--output",
                        os.path.join(root, f"serve_{name}_{int8}.npz"),
                        "--batch-size", "256", "--precision", "bf16",
                        "--device", DEVICE]
                if name == "s16":
                    argv += ["--images", img_dir]
                if int8:
                    argv += ["--int8-mlp"]
                elif name == "s16":
                    argv += ["--export", export_dir]
                tag = f"serve {'int8' if int8 else 'bf16'} {name}"
                n_text = -(-len(caps_n) // 256) + 1
                n_image = 2 if name == "s16" else 0
                with _Encodes(counters["serve_int8"] if int8 else _Counters(),
                              tag, (n_text, n_image), label="(p)") as enc:
                    res = serve.main(argv)
                feats[(name, int8)] = res
                text_line = handler.last("text:")
                row = {"seconds": enc.seconds, "text": text_line,
                       "launches": enc.launches}
                if name == "s16":
                    row["image"] = handler.last("image:")
                if int8:
                    row["int8"] = handler.last("int8 MLP")
                serve_out[tag] = row
                say(f"(p) {tag}: {row}")
        for name in sets:
            for k in ("text_features", "image_features"):
                if k not in feats[(name, True)]:
                    continue
                q, f = feats[(name, True)][k], feats[(name, False)][k]
                cos = np.sum(q * f, -1) / (np.linalg.norm(q, axis=-1)
                                           * np.linalg.norm(f, axis=-1))
                require(cos.min() >= 0.99, f"int8 {name} {k}: min cosine "
                        f"{cos.min()}")
                serve_out[f"int8 vs bf16 {name} {k} min cosine"] = \
                    float(cos.min())
                say(f"(p) int8 vs bf16 {name} {k}: min cosine {cos.min():.5f}")
    finally:
        log.removeHandler(handler)
    out["serve"] = serve_out

    paths = {k: os.path.join(export_dir, f"{MODEL}.{k}.pt2")
             for k in ("text", "image")}
    eps = {k: export.load_exported(p) for k, p in paths.items()}
    cfg = get_model_config(MODEL)
    for k, ep in eps.items():
        n = sum(1 for node in ep.graph.nodes if node.op == "call_function"
                and "fused_attention_block" in str(node.target))
        layers = cfg.text.layers if k == "text" else cfg.vision.layers
        require(n == layers, f"exported {k}: {n} block nodes, {layers} "
                "expected")
    eager = create_model(MODEL, precision="bf16", seed=0, device=DEVICE)
    tok = get_tokenizer(MODEL)
    toks = torch.from_numpy(tok(sets["s16"][:256])).to(DEVICE)
    pre = image_transform(cfg.vision.image_size)
    imgs = np.stack([pre(np.load(os.path.join(img_dir, f)))
                     for f in sorted(os.listdir(img_dir))])
    imgs = torch.from_numpy(np.concatenate([imgs, imgs])).to(
        DEVICE, torch.bfloat16)
    ex = counters["export"]
    torch.cuda.synchronize()
    ex.zero()
    with torch.inference_mode():
        got = {"text": eps["text"].module()(toks),
               "image": eps["image"].module()(imgs)}
        torch.cuda.synchronize()
        launches = {n: op.launches for n, op in ex.ops.items()}
        ref = {"text": eager.module.encode_text(toks, True),
               "image": eager.module.encode_image(imgs, True)}
    want_l = {"packed_attention": cfg.text.layers + cfg.vision.layers,
              "fused_attention_block": cfg.text.layers + cfg.vision.layers,
              "layer_norm": cfg.text.layers + 1 + cfg.vision.layers + 2}
    require(launches == want_l, f"export launches {launches} != {want_l}")
    for n in ex.NAMES:
        ex.total[n] += launches[n]
    diffs = {k: float((got[k].float() - ref[k].float()).abs().max())
             for k in got}
    equal = {k: bool(torch.equal(got[k], ref[k])) for k in got}
    require(max(diffs.values()) <= 2e-2, f"exported vs eager: {diffs}")
    out["export"] = {"max_abs": diffs, "bitwise_equal": equal,
                     "launches": launches,
                     "artifact_gb": {k: gb(p) for k, p in paths.items()}}
    say(f"(p) exported artifacts on the card: launches {launches}; vs eager "
        f"bf16 max abs {diffs}, bitwise equal {equal}; sizes "
        f"{out['export']['artifact_gb']} GB")
    del eps, eager, got, ref
    shutil.rmtree(export_dir)

    # ---- the profiler -------------------------------------------------------
    t0 = time.perf_counter()
    card_row = profiler.main(["--model", MODEL, "--device", DEVICE])[0]
    cpu_row = profiler.profile_model(MODEL, device="cpu")
    for k in ("gflops_image", "gflops_text"):
        rel = abs(card_row[k] - cpu_row[k]) / cpu_row[k]
        require(rel <= 0.01, f"profiler {k}: card {card_row[k]} vs CPU "
                f"{cpu_row[k]}")
    require(card_row["mparams"] == cpu_row["mparams"], "profiler mparams")
    out["profiler"] = {"card": card_row, "cpu": cpu_row,
                       "seconds": time.perf_counter() - t0}
    say(f"(p) profiler on the card {card_row}; on the CPU {cpu_row}")

    # ---- the trainer's run management ---------------------------------------
    trace_dir, mirror = os.path.join(root, "trace"), os.path.join(root,
                                                                  "mirror")
    t0 = time.perf_counter()
    res = driver.main(TRAIN_FLAGS + [
        "--logs", root, "--name", "runmgmt", "--profile-dir", trace_dir,
        "--remote-sync", mirror, "--copy-codebase", "--matmul-precision",
        "highest"])
    seconds = time.perf_counter() - t0
    traces = os.listdir(trace_dir)
    mirrored = sorted(os.listdir(os.path.join(mirror, "runmgmt",
                                              "checkpoints")))
    require(traces == ["trace_epoch0_batches2-5.json"], f"traces {traces}")
    require("epoch_1" in mirrored, f"mirrored checkpoints {mirrored}")
    require(os.path.isfile(os.path.join(root, "runmgmt", "code",
                                        "leaf_tpu_torch", "serve.py")),
            "no code snapshot")
    require(torch.get_float32_matmul_precision() == "highest",
            "matmul precision")
    out["trainer"] = {"seconds": seconds, "trace_mb": os.path.getsize(
        os.path.join(trace_dir, traces[0])) / 1e6, "mirrored": mirrored,
        "steps": res["state"].step}
    say(f"(p) train.driver.main with --profile-dir, --remote-sync, "
        f"--copy-codebase, --matmul-precision highest: {out['trainer']}")
    shutil.rmtree(root, ignore_errors=True)
    launches = {path: c.total for path, c in counters.items()}
    return launches, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.ops import packed_attention as pa

    t_start = time.perf_counter()
    phase_card()
    _timed("b", phase_build)
    rows, parts = _timed("c", phase_kernels)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        images = np.random.default_rng(1).standard_normal(
            (256, 224, 224, 3)).astype(np.float32)
        pa.packed_attention.launches = 0
        pa.fused_attention_block.launches = 0
        pa.layer_norm.launches = 0
        t0 = time.perf_counter()
        rates, text_batches, sets = phase_serve(workdir)
        card_bf16 = create_model(MODEL, precision="bf16", seed=0,
                                 device="cuda")
        img_rate, img_batches = phase_images(card_bf16, images)
        serve_launches = {
            "packed_attention": pa.packed_attention.launches,
            "fused_attention_block": pa.fused_attention_block.launches}
        cfg = card_bf16.cfg
        need = cfg.text.layers * text_batches + cfg.vision.layers * img_batches
        say(f"(g) launches during (d)+(e): {serve_launches}; at least {need} "
            f"expected ({cfg.text.layers} x {text_batches} text batches + "
            f"{cfg.vision.layers} x {img_batches} image batches)")
        for name, n in serve_launches.items():
            require(n >= need, f"{name}: {n} launches < {need}")
        ln_serve = pa.layer_norm.launches
        ln_need = ((cfg.text.layers + 1) * text_batches
                   + (cfg.vision.layers + 2) * img_batches)
        say(f"(g) layer_norm launches during (d)+(e): {ln_serve}; at least "
            f"{ln_need} expected (({cfg.text.layers} + 1) x {text_batches} "
            f"text batches + ({cfg.vision.layers} + 2) x {img_batches} image "
            f"batches)")
        require(ln_serve >= ln_need, f"layer_norm: {ln_serve} launches < {ln_need}")
        phase_parity(card_bf16, sets, images)
        del card_bf16, images
        torch.cuda.empty_cache()
        PHASE_SECONDS["d-g"] = round(time.perf_counter() - t0, 1)

        flash_launches = _timed("h", phase_flash, cfg.vision.layers)
        _timed("i train", phase_train_parity)
        _timed("i fused", phase_fused_parity)
        train_launches, trainer = _timed("j", phase_train, workdir)
        eval_parity = _timed("k parity", phase_eval_parity, workdir)
        eval_launches, recipe = _timed("k", phase_recipe, workdir)
        charmer_parity = _timed("l parity", phase_charmer_parity, workdir)
        attack_launches, text_attacks = _timed("l", phase_text_attacks,
                                               workdir)
        fare_parity = _timed("m parity", phase_fare_parity, workdir)
        fare_launches, fare_runs = _timed("m FARE", phase_fare, workdir)
        robust_launches, robust = _timed("m robust", phase_robust, workdir)
        clip_parity = _timed("n parity", phase_contrastive_parity, workdir)
        clip_launches, clip_runs = _timed("n", phase_contrastive, workdir)
        bench_parity = _timed("o parity", phase_benchmark_parity, workdir)
        bench_launches, pez_launches, bench_runs = _timed(
            "o", phase_benchmark, workdir)
        t2i_parity = _timed("p parity", phase_t2i_parity, workdir)
        t2i_launches, t2i_runs = _timed("p", phase_t2i_tooling, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    say(f"(d) text encodes/s: bucket 16 {rates['s16']:.1f}, "
        f"bucket 77 {rates['s77']:.1f}; (e) images/s {img_rate:.1f}")
    sources = {"packed_attention": "leaf_tpu_torch/ops/csrc/packed_attention.cu",
               "fused_attention_block": "leaf_tpu_torch/ops/csrc/fused_block.cu",
               "flash_attention": "leaf_tpu_torch/ops/csrc/flash_attention.cu"}
    replaces = {"packed_attention": "leaf_tpu/ops/packed_attention.py:96",
                "fused_attention_block": "leaf_tpu/ops/packed_attention.py:208",
                "flash_attention": "leaf_tpu/ops/flash_attention.py:44"}
    by_path = {
        "packed_attention": {"serve": serve_launches["packed_attention"],
                             "train": train_launches["packed_attention"],
                             "eval": eval_launches["packed_attention"],
                             "text_attacks":
                                 attack_launches["packed_attention"],
                             "fare": fare_launches["packed_attention"],
                             "robust_eval":
                                 robust_launches["packed_attention"],
                             "contrastive":
                                 clip_launches["packed_attention"],
                             "benchmark": bench_launches["packed_attention"],
                             "pez": pez_launches["packed_attention"],
                             **{path: t2i_launches[path]["packed_attention"]
                                for path in t2i_launches}},
        "fused_attention_block": {
            "serve": serve_launches["fused_attention_block"],
            "train": train_launches["fused_attention_block"],
            "eval": eval_launches["fused_attention_block"],
            "text_attacks": attack_launches["fused_attention_block"],
            "fare": fare_launches["fused_attention_block"],
            "robust_eval": robust_launches["fused_attention_block"],
            "contrastive": clip_launches["fused_attention_block"],
            "benchmark": bench_launches["fused_attention_block"],
            "pez": pez_launches["fused_attention_block"],
            **{path: t2i_launches[path]["fused_attention_block"]
               for path in t2i_launches}},
        "flash_attention": {"op": flash_launches}}
    report = []
    for name, by_shape in rows.items():
        for path, count in by_path[name].items():
            require(count > 0, f"{name}: no launch on the {path} path")
        # the shape the main path runs most: the scoring encode of
        # `train.driver.main`'s fused step (a half batch's 3200 candidates
        # at bucket 16, 400 rows) for the packed kernels, the vision shape
        # for flash attention; every shape is on the "kernel_shapes" line
        main_shape = next((r for r in by_shape
                           if r["shape"] == FUSED_MAIN_SHAPE), by_shape[0])
        report.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name],
            "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
            "shape": main_shape["shape"], "dtype": main_shape["dtype"]})
    # the LayerNorm op's launches outside the block; its rows by shape and
    # the GEMM's are on the "kernel_shapes" line
    ln_launches = {"serve": ln_serve, "train": train_launches["layer_norm"],
                   "eval": eval_launches["layer_norm"],
                   "text_attacks": attack_launches["layer_norm"],
                   "fare": fare_launches["layer_norm"],
                   "robust_eval": robust_launches["layer_norm"],
                   "contrastive": clip_launches["layer_norm"],
                   "benchmark": bench_launches["layer_norm"],
                   "pez": pez_launches["layer_norm"],
                   **{path: t2i_launches[path]["layer_norm"]
                      for path in t2i_launches}}
    for path, count in ln_launches.items():
        require(count > 0, f"layer_norm: no launch on the {path} path")
    require(report[1]["name"] == "fused_attention_block", "report order")
    report[1]["parts"] = {"layer_norm": {"launches": sum(ln_launches.values()),
                                         "launches_by_path": ln_launches}}
    PHASE_SECONDS["all"] = round(time.perf_counter() - t_start, 1)
    say(f"phase seconds: {PHASE_SECONDS}")
    print(json.dumps({"phase_seconds": PHASE_SECONDS,
                      "trainer": trainer, "recipe": recipe,
                      "eval_parity": eval_parity,
                      "charmer_parity": charmer_parity,
                      "text_attacks": text_attacks,
                      "fare_parity": fare_parity, "fare": fare_runs,
                      "robust_eval": robust,
                      "contrastive_parity": clip_parity,
                      "contrastive": clip_runs,
                      "benchmark_parity": bench_parity,
                      "benchmark": bench_runs, "t2i_parity": t2i_parity,
                      "t2i": t2i_runs}, default=float))
    # every shape's row (ms, plain_ms, library_ms, bound_ms, bound_by,
    # max_abs_err) on a line of its own, so that the kernels line stays
    # short enough to read whole from the end of a captured output
    print(json.dumps({"kernel_shapes": {**rows, **parts}}))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
