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
      operations (fp32 products of both attention kernels, the block and
      its GEMM at the 3xTF32 rate, 495 / 3 TFLOP/s; a kernel time below its
      bound fails the phase) (these times include each wrapper's host
      time; flash attention, the fused block and its parts are also timed
      on the device alone, 20 calls replayed from one CUDA graph); then,
      untimed, both tensor-core attention kernels over a sweep of ragged
      shapes in bf16 and fp32 (groups of 13 to 257 tokens, heads of 8 to
      128, sequences of 1 to 600; heads of 5 to 128 for the packed kernel
      in fp32), the fp32 GEMM at the ragged shapes and PEZ's M = 77, with
      and without the residual, the LayerNorm at widths 8 to 4096 that
      take every plan of its kernel (1, 7 and 333 rows, both dtypes; the
      plan's Python mirror held to the library's), and the gradients of
      one shape of each through the public ops (kernels forward and
      backward) against autograd through the plain versions; the
      backward kernels (`phase_backward`): the attention backward and the
      LayerNorm backward at the differentiated paths' shapes (FARE's ViT-H
      [128, 257, 3840] bf16, the eval's [128, 257, 3072] fp32, contrastive
      text [256, 77, 1536] causal and vision [256, 50, 2304], the LEAF
      step's rows of 16 in 128, the robust eval's and PEZ's fp32 rows; the
      LayerNorm at 32,896 x 1280 bf16, 32,896 x 1024 fp32, 19,712 x 512
      bf16, 16,448 x 2730 bf16 and the fp32 conv stems) held to autograd
      through the plain forward and to the explicit plain backward (2e-2
      of the largest gradient in bf16, 1e-4 in fp32), two runs equal bit
      for bit, timed against the plain backward and the library's (SDPA's,
      `F.layer_norm`'s), with their bounds; the fused block's backward,
      all seven gradients and the input's alone, against autograd through
      `_block_reference`; a sweep of groups, head widths and LayerNorm
      widths through both backward kernels; and the fused
      block's parts alone, bf16: the GEMM + bias kernel at the block's qkv
      and out-projection shapes (text buckets 16 and 77, vision, the fused
      and the unfused train step's; the out-projections also with their
      residual) and at three ragged
      shapes in every tile width, with `torch.addmm` as its library call
      and its operations bound, and in fp32 at the eval's vision qkv and
      out-projection shapes; the LayerNorm op at every row width the paths
      give it, with the plan its kernel takes (held to the Python mirror),
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
      two train steps on the card (kernels forward and backward)
      against the same on the CPU (plain versions); then the fused
      attack+train step: on the card it picks the sentences of the unfused
      attack + train step (free and constrained), and two fused steps are
      within 1e-4 of the CPU's (same sentences, loss, parameters);
  (j) the trainer on ViT-L-14-quickgelu at its full width, cut in depth
      like every tower of (j) to (p) but (n)'s (`DEPTH_CUTS`: ViT-L-14 to 4
      vision and 4 text layers of 24 and 12, ViT-H-14 to 4 and 6 of 32 and
      24, the vision towers at 8 until (w); every block keeps its shape)
      (bf16 compute on fp32 master
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
      full width, cut in depth (bf16 on fp32 master weights, batch 128, rho 50,
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
      ViT-L-14-quickgelu's full width, cut in depth (random weights, seed
      0), through each command line's `main` on the card: `evals.textfare` on
      the synthetic sentences (charmer and leaf at 32 sentences, rho 50,
      bf16; charmer in fp32 at 8; bruteforce at 4), `evals.zero_shot_text`
      with `scripts/dress_rehearsal.sh`'s flags (32 sentences, rho 20, image
      anchors, bf16), `evals.retrieval` on 32 seeded 256 x 256 `.npy`
      images with 5 captions each (rho 10, bf16, untargeted and `--target
      0`), and `train.driver.main --use_charmer` (batch 128, rho 50, k 1):
      2 steps on "Dummy caption", 1 step with `--constrain` on (k)'s tar
      set.  Each part prints its seconds, its candidates per second, its
      chunks per scoring call and its peak device memory, with the
      kernels' counters held to a fused block per layer and one LayerNorm
      more per text encode, two more per image encode;
  (m) FARE and the ImageNet robust eval: first, at ViT-tiny-test, fp32,
      TF32 off, the card against the CPU from the same weights: 2 FARE
      steps with PGD from the same starts and 2 with APGD give the same
      losses and parameters (1e-4), the APGD cascade and Square the same
      fooled masks and adversarial images (1e-4); `train.fare_driver.main`
      on the card for 3 steps and again with `--resume latest --steps 5`
      (Adam's moments and step carried, the milestones there, no fallback
      left); then at ViT-H-14's full width, cut in depth (random weights,
      seed 0; D 1280, 16 heads of width 80, GELU): `fare_driver.main` with
      `scripts/train_fare_vith.sh`'s flags (bf16 on fp32 master weights,
      batch 128, PGD-10 L-inf at eps 2/255, AdamW at lr 1e-5, wd 1e-4;
      1 step with remat (3 until phase (u) needed the room) where the
      recipe has 10,000 after 700 warm-up steps)
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
      image-caption pairs in 8 tar shards: 2 plain steps (8 until phase
      (u), 4 until phase (v) needed the room; cosine after 2 warm-up steps)
      with `--val-data` over one more shard before and after, saved;
      `--resume latest` for 1 more (2 until (v)); 1 step each (2 until (v))
      with
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
      ViT-L-14-quickgelu's full width, cut in depth (random weights, seed
      0) through each command line's `main` on the card: `cli eval` (fp32,
      batch 64) on a CIFAR-10 pickle layout of 1,024 seeded images, an
      imagenet1k WordNet-id folder (8 classes, 64 `.npy` images, 80
      templates), the CIFAR set in bf16, APGD (10 iterations, CE + 3
      targets) on 32 CIFAR images, a Karpathy retrieval JSON (64 images x
      5 captions), a SugarCrepe JSON (64 records), the linear probe on
      8-class folders (256 / 64 images, 100 epochs) and with `--fewshot-k
      8`; `build` and `reformat` over the JSONs; `evals.pez_driver.main`
      on 2 seeded captions (150 iterations; the default is 3,000) and on 2
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
      width, cut in depth (random weights): `convert.main` OpenCLIP -> HF ->
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
      launches to its encodes;
  (q) CoCa: first, at coca-tiny-test, fp32, TF32 off, the card against the
      CPU from the same seeded weights: the encoders, the training forward's
      logits and `coca_loss` within 1e-5, greedy and beam-search ids equal,
      one train step's parameters within 1e-5 (the attention key biases,
      whose true gradient is zero, within 2 lr); then at full width
      (random weights, seed 0): `benchmark.cli eval --task captioning`
      with coca_ViT-L-14 cut to 8 vision, 4 text and 4 decoder layers
      (`COCA_DEPTH_CUTS`; full depth until phase (v)) (fp32, batch 64) on a Karpathy JSON of 64 seeded
      224 x 224 `.npy` images with 5 captions each (COCO's 5,000 test
      images cut to a call), with the default beam search (K 6, G 3,
      seq_len 30) and with `--generation-type top_k`: seconds, captions/s
      after the build, ms a generated position, peak memory, BLEU-4 in
      [0, 1] and CIDEr-D >= 0 over 64 samples; `contrastive_driver.main
      --model coca_ViT-B-32` with (n)'s flags on its tar shards (bf16 on
      fp32 masters, batch 256), 2 steps (4 until phase (u) needed the
      room) and a resume for 1: device seconds
      a step (CUDA events), pairs/s, the loader's wait, peak memory, finite
      losses, the resume at the saved step; `utils.profiler.main --model
      coca_ViT-L-14` on the card within 1% of the CPU count; one beam
      search and one greedy generation of the 64 images (at the cut depth)
      under
      `torch.profiler` (device busy, idle share, time by kernel family).
      Every part
      holds the kernels' launches to its image and text encodes, decodes,
      generation caches and cached steps (`_coca_launches`); (c) has a
      LayerNorm row at the cached step's shape;
  (r) the ViT-family zoo: first siglip-tiny-test, mci-vit-tiny-test and
      fastvit-tiny-test in fp32, TF32 off, the card against the CPU from the
      same seeded weights (image and text features within 1e-4); then at full
      width, bf16, random weights from seed 0 (full depth but SO400M's, cut
      to 9 + 9 of its 27 + 27 layers by `ZOO_DEPTH_CUTS` since phase (v)):
      MobileCLIP-B
      (MCi-ViT, 197 tokens, D 768; causal text at 77, D 512) through
      `serve.main`, 2,048 seeded captions at batch 256 and 256 seeded 224 x
      224 `.npy` images at batch 128; MobileCLIP-S2's `encode_image` on 128
      seeded 256 x 256 images (the FastViT trunk runs `F.conv2d` and plain
      attention: no kernel launch) and `encode_text` on 256 captions (77
      tokens, not causal); ViT-SO400M-14-SigLIP-384 through `serve.main
      --images` on 128 seeded 384 x 384 images at batch 64 (blocks of [64,
      729, 1152], 16 heads of 72, no class token, the MAP head) and its
      `encode_text` on 256 seeded rows of 64 ids (2 non-causal groups a
      128-token row; its SentencePiece tokenizer is not ported); the two
      served image sets also already decoded, straight to `encode_image`
      (the host's decode against the device).  Each part
      holds the kernels' launches to its encodes (`_zoo_launches`), prints
      encodes/s, seconds and peak memory, and holds its first 8 rows' bf16
      features to cosine >= 0.99 against the same model's fp32 ones on the
      card, TF32 off.  (c) has rows at the zoo's shapes: both kernels and the
      LayerNorm at [64, 729, 1152] bf16 (and [8, 729, 1152] fp32, where the
      fp32 kernel takes its ring of 64-key stages), [128, 128, 1152] bf16 in
      groups of 64 not causal, [128, 197, 768] bf16 and [256, 77, 512] bf16
      not causal, and the block's GEMMs at those shapes; the sweep has heads
      of 72, rows of 728-730 tokens and the non-causal text groups;
  (s) the ModifiedResNet, ConvNeXt, EVA and ViTamin towers: first a tiny
      ModifiedResNet (one bottleneck a stage, width 8, 64 px),
      convnext-tiny-test, eva-tiny-test and vitamin-tiny-test in fp32, TF32
      off, the card against the CPU from the same seeded weights (image and
      text features within 1e-4); then at full width and depth, bf16,
      random weights from seed 0: RN50 through `serve.main` (2,048 seeded
      captions at batch 256, 256 seeded 224 x 224 `.npy` images at batch
      128; cuDNN bottlenecks and the plain attention pool: no kernel launch
      for images), and 128 of the images decoded already; convnext_base_w's
      `encode_image` on 128 seeded 256 x 256 images at batch 64 (41
      LayerNorm launches an encode, NHWC rows from 262,144 x 128 down) and
      `encode_text` on 256 captions (D 640, 10 heads); EVA02-L-14 through
      `serve.main --images` (128 at batch 64; plain rope attention, 97
      LayerNorms an encode, `mlp.ln` at D 2730), then `encode_text` on 256
      captions and a decoded batch of 64; ViTamin-L's `encode_image` on 128
      at batch 64 (102 LayerNorms an encode, the stem's over 802,816 rows of
      160) and `encode_text` on 256 captions.  Each part holds the kernels'
      launches to its encodes (`_convnet_launches`), prints encodes/s,
      seconds and peak memory, and holds its first 8 rows' bf16 features to
      cosine >= 0.99 against the same model's fp32 ones on the card, TF32
      off.  (c) has rows at the new shapes: both kernels and the LayerNorm
      at [256, 77, 640] causal bf16, the block's GEMMs at 19,712 x 640 x
      1920 and x 640, and the LayerNorm at 262,144 x 128, 16,448 x 2730
      (and 2,056 x 2730 fp32) and 802,816 x 160;
  (t) the rest of the served zoo: first swin-tiny-test, relpos-tiny-test,
      tiny RoBERTa, mT5 and M2M100 `HFTextTower`s and
      coca-roberta-tiny-test in fp32, TF32 off, the card against the CPU
      from the same seeded weights (features within 1e-4, greedy ids
      equal); then at full width and depth, random weights from seed 0:
      swin_base_patch4_window7_224 and vit_relpos_medium_patch16_cls_224
      through `serve.main` in bf16 (texts and images), nllb-clip-base,
      xlm-roberta-base-ViT-B-32 and mt5-base-ViT-B-32 (the HF tower fp32,
      as the JAX package builds it; the ViT-B-32 in bf16) on seeded
      77-token ids with ragged padding and seeded images, and
      coca_roberta-ViT-B-32's features (its generation fails on its own
      shapes, as in OpenCLIP and the JAX package).  Each part holds its
      launches (`_rt_launches`) and its bf16 rows to cosine >= 0.995
      against fp32.  (c) has LayerNorm rows at Swin-B's 200,704 x 128 and
      3,136 x 2048 (bf16) and the HF towers' 19,712 x 1024 and x 768
      (fp32).
  (u) training the zoo: first, tiny, fp32, TF32 off, the card against
      the CPU from the same seeded weights, one step each: the contrastive
      step on every vision family (SigLIP with its sigmoid loss and logit
      bias, MobileCLIP's MCi-ViT and FastViT, ConvNeXt, EVA, ViTamin, Swin,
      RelPos-ViT, a CLIPA-shaped ViT, a tiny ModifiedResNet whose BatchNorm
      statistics stay put) and coca-roberta-tiny-test's CoCa step; the
      fused LEAF step on a SigLIP-style, a CLIPA-style and a 640-wide text
      tower (the same adversarial sentences); the in-training eval's PGD
      through every vision family; a FARE step at siglip-tiny-test and the
      CLIPA shape (losses and parameters within 1e-4); then at full width
      and depth, bf16 on fp32 master weights, two steps a cell:
      `train.driver.main` at convnext_base_w (batch 32, rho 20, the fused
      step; its zero-shot eval before and after the epoch, PGD-10 through
      the ConvNeXt tower on 16 seeded images); the contrastive step at RN50
      (BatchNorm statistics bit for bit), EVA02-L-14 and ViT-B-16-SigLIP
      (the sigmoid loss, seeded ids), batch 32; FARE on the SigLIP tower
      with remat, PGD-10, batch 32.  Each cell's launches are held to the
      count its config gives; losses finite; seconds a step and peak
      memory printed;
  (v) multiple ranks (`leaf_tpu_torch.parallel.distributed`): two ranks in
      spawned processes (`python chip_smoke.py --v-rank <spec>`, the
      launcher's variables set) on the one card over gloo (NCCL refuses two
      ranks on one device); tiny, fp32, TF32 off, the card against the same
      two-rank runs on the CPU: three fused LEAF steps (anchors missed,
      every rank hits, one rank misses), an unfused step, InfoNCE global and
      `--local-loss`, the SigLIP ring, a FARE step (losses within 1e-5 of
      their scale, parameters equal bit for bit across ranks, the same
      widths, branches and sentences); at full width, bf16 on fp32 masters,
      2 steps each, the fused LEAF step at ViT-L-14-quickgelu's text tower
      (global batch 128, rho 50, bucket 16) and the contrastive step at
      ViT-B-32 (global batch 256) with InfoNCE and SigLIP: s a step, the
      collectives' share, each rank's launches held to its encodes; and
      `python -m leaf_tpu_torch.train.driver` at world 1 on NCCL under
      RANK=0 WORLD_SIZE=1 equal, bit for bit, to the run without the
      variables.  With two or more cards the full-width part also runs on
      NCCL across them; with one, a line says that it did not;
  (w) prefix-reuse candidate encoding (`models.prefix_encode`) and tensor
      parallelism (`parallel.sharding`): tiny, fp32, TF32 off, the prefix
      path (unpacked and packed) on the card against the card's full encode
      and the CPU, the LayerNorm kernel's launches held; the fused LEAF step
      on a (data 1, model 2) grid of two gloo ranks on the card (`python
      chip_smoke.py --w-rank <spec>`) against the same grid on the CPU and
      the one-rank step on the card and the CPU (losses within 1e-5 of
      their scale, parameters within 2e-4, the key bias within 2 lr a step,
      the same sentences), whole parameters equal bit for bit across ranks;
      at ViT-L-14-quickgelu's text tower (12 x 768, bf16): `clean_kv` +
      `encode_text_suffix_packed` against `encode_text` on one step's 6,400
      bucket-16 candidates of 64 captions (rho 50, both phases), CUDA-event
      times in turns, cosine >= 0.99; the fused step at model 2 (global
      batch 16, rho 50, bf16 on fp32 masters), 2 steps: s a step, the
      collectives' share, each rank's LayerNorm, GEMM and packed-attention
      launches held to its encodes; (c) has rows at the shapes it gives the
      GEMM (N 1,152, K 384) and the packed kernel (6 heads).
(j), (k), (m), (n), (o), (u), (v) and (w) run under a guard
(`_BackwardGuard`): no plain version of the op module runs on a CUDA tensor
in the phase (its count `PLAIN_ON_CUDA` stays 0, in the rank processes too),
and the attention and LayerNorm backward kernels launch; each phase's
backward launches are printed and go into the kernels' report; (m)'s FARE
steps and (n)'s device steps hold them exactly, a block, an attention and
an `ln_1` backward per block and a LayerNorm backward per other LayerNorm,
for every differentiated encode.
Any failure raises.  The line before the last is the kernels' JSON
report (each kernel at its main-path shape; the line before it has the
rows of every shape); the last is {"ok": true, "device": {...}}.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
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
    # the ViT-family zoo (r): ViT-SO400M-14-SigLIP-384's image batch of 64
    # (27 x 27 = 729 tokens, no class token, 16 heads of 72) and its fp32
    # parity slice of 8, whose visible keys do not fit shared memory whole
    # (both kernels take the ring of 64-key stages); its text, 256 rows of 64 ids packed
    # 2 to a 128-token row, not causal; MobileCLIP-B's images (196 patches
    # + the class token, D 768); MobileCLIP-S2's text, 77 tokens not causal
    ("siglip_vision_bf16", 64, 729, 729, False, 1152, 16, "bfloat16"),
    ("siglip_vision_fp32", 8, 729, 729, False, 1152, 16, "float32"),
    ("siglip_text_s64_bf16", 128, 128, 64, False, 1152, 16, "bfloat16"),
    ("mobileclip_b_vision_bf16", 128, 197, 197, False, 768, 12, "bfloat16"),
    ("mobileclip_s2_text_s77_bf16", 256, 77, 77, False, 512, 8, "bfloat16"),
    # (s): convnext_base_w's text tower (and RN50x4's), D 640 in 10 heads of
    # 64, a batch of 256 captions at bucket 77, causal
    ("convnext_text_s77_bf16", 256, 77, 77, True, 640, 10, "bfloat16"),
    # (u), training the zoo: the LEAF trainer at convnext_base_w scores a
    # half batch's 16 x 20 = 320 candidates at bucket 16 (8 a row, D 640);
    # ViT-B-16-SigLIP's contrastive and FARE batches of 32 images (196
    # patches, no class token) and its 32 captions of 64 ids, 2 a row, not
    # causal
    ("zoo_leaf_s16_d640_bf16", 40, 128, 16, True, 640, 10, "bfloat16"),
    ("zoo_siglip_b16_vision_bf16", 32, 196, 196, False, 768, 12,
     "bfloat16"),
    ("zoo_siglip_b16_text_s64_bf16", 16, 128, 64, False, 768, 12,
     "bfloat16"),
]
# (w), tensor parallelism at model 2: a rank's packed attention on its 6
# of ViT-L text's 12 heads (D 384 of 768), at the TP cell's candidate
# scoring (800 candidates at bucket 16, 100 rows); the packed kernel alone,
# the block runs split
TP_SHAPES = [("tp_s16_h6_bf16", 100, 128, 16, True, 384, 6, "bfloat16")]
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
               ("b32 vision out", 256 * 50, 768, 768),
               # (r): M = 46,656 is no multiple of a 128-row tile
               ("siglip vision qkv", 64 * 729, 1152, 3456),
               ("siglip vision out", 64 * 729, 1152, 1152),
               ("siglip text qkv", 128 * 128, 1152, 3456),
               ("siglip text out", 128 * 128, 1152, 1152),
               ("mobileclip-b vision qkv", 128 * 197, 768, 2304),
               ("mobileclip-b vision out", 128 * 197, 768, 768),
               # (s): the text tower at D 640, K 640 and N 1920
               ("d640 text qkv", 256 * 77, 640, 1920),
               ("d640 text out", 256 * 77, 640, 640),
               # (w): a model-2 rank's qkv columns (N 1,152) and its rows
               # of the out-projection (K 384, summed across the ranks
               # before the bias: no residual) at the TP cell's scoring
               ("tp s16 qkv", 100 * 128, 768, 1152),
               ("tp s16 out rows", 100 * 128, 384, 768)]
# M = 3 rows of 77 tokens; N and K multiples of 8 and of no tile (64 k, 128
# to 256 columns), one of them narrower than a single TMA box
# the eval's fp32 vision GEMMs: the block's qkv and out projections
EVAL_FP32_GEMM_SHAPES = [("eval vision qkv fp32", 128 * 257, 1024, 3072),
                         ("eval vision out fp32", 128 * 257, 1024, 1024),
                         ("robust vith qkv fp32", 32 * 257, 1280, 3840),
                         ("robust vith out fp32", 32 * 257, 1280, 1280),
                         ("bench vision qkv fp32", 64 * 257, 1024, 3072),
                         ("bench vision out fp32", 64 * 257, 1024, 1024)]
# (name, M, D, dtype name) of the LayerNorm op beyond SHAPES' rows: CoCa's
# cached captioning step (q), one position of each of 64 images x 6 beams:
# 73 LayerNorms a step, 2,117 of a beam-search batch's 2,157 at coca_ViT-L-14
# and (s)'s towers, batches of 64 images: ConvNeXt's stem LN over 64 x 64
# pixels of 128 channels (convnext_base_w at 256 px: 16 pieces a row, the
# narrow plan), EVA02-L's `mlp.ln` at D 2730, no multiple of a 16-byte piece
# (rows of 4-byte words; also fp32 on the parity slice of 8 images),
# ViTamin-L's stem LN over 112 x 112 pixels of 160 channels (20 pieces)
LN_SHAPES = [("coca_decode_step_fp32", 64 * 6, 768, "float32"),
             ("convnext_stem_bf16", 64 * 64 * 64, 128, "bfloat16"),
             ("eva02_mlp_ln_bf16", 64 * 257, 2730, "bfloat16"),
             ("eva02_mlp_ln_fp32", 8 * 257, 2730, "float32"),
             ("vitamin_stem_bf16", 64 * 112 * 112, 160, "bfloat16"),
             # (t): Swin-B's patch norm and stage-0 LNs over 56 x 56 pixels
             # of 128 channels, its last patch merge's 2048-wide rows (7 x
             # 7 a image: above 1024, the wide plan), serve's batch of 64;
             # NLLB's M2M100 text rows at D 1024 and XLM-R's at 768, fp32
             # as the HF towers run, 256 rows of 77 ids
             ("swin_stage0_bf16", 64 * 56 * 56, 128, "bfloat16"),
             ("swin_merge3_bf16", 64 * 7 * 7, 2048, "bfloat16"),
             ("m2m100_text_fp32", 256 * 77, 1024, "float32"),
             ("xlmr_text_fp32", 256 * 77, 768, "float32"),
             # (u): EVA02-L's `mlp.ln` in a contrastive batch of 32; the
             # LEAF eval's ConvNeXt stem in fp32 on 16 images of 256 px
             ("eva02_train_mlp_ln_bf16", 32 * 257, 2730, "bfloat16"),
             ("convnext_eval_stem_fp32", 16 * 64 * 64, 128, "float32")]
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
# the attention backward (c) at the differentiated paths' shapes, as SHAPES:
# FARE's ViT-H batch (m, bf16), the eval's PGD through ViT-L's vision tower
# (k, fp32), the contrastive text and vision batches (n), the LEAF step's
# 128 captions at bucket 16 (j), the robust eval's ViT-H batch (m, fp32) and
# PEZ's prompt (o, fp32)
BWD_SHAPES = [
    ("fare_vith_bf16", 128, 257, 257, False, 1280, 16, "bfloat16"),
    ("eval_vision_fp32", 128, 257, 257, False, 1024, 16, "float32"),
    ("contrastive_text_s77_bf16", 256, 77, 77, True, 512, 8, "bfloat16"),
    ("contrastive_vision_bf16", 256, 50, 50, False, 768, 12, "bfloat16"),
    ("leaf_train_s16_bf16", 16, 128, 16, True, 768, 12, "bfloat16"),
    ("robust_vith_fp32", 32, 257, 257, False, 1280, 16, "float32"),
    ("pez_text_s77_fp32", 1, 77, 77, True, 768, 12, "float32"),
]
BWD_MAIN_SHAPE = "fare_vith_bf16"
# the fused block's backward, all seven gradients and the input's alone
# (PGD through a frozen tower), at four of those shapes
BLOCK_BWD_SHAPES = ("fare_vith_bf16", "eval_vision_fp32",
                    "contrastive_text_s77_bf16", "leaf_train_s16_bf16")
# (name, M, D, dtype name) of the LayerNorm backward: FARE's ViT-H rows, the
# eval's fp32 vision rows, the contrastive text rows, EVA02-L's `mlp.ln` (u),
# the LEAF eval's fp32 PGD through the ConvNeXt and ViTamin stems (u)
LN_BWD_SHAPES = [("fare_vith_bf16", 128 * 257, 1280, "bfloat16"),
                 ("eval_vision_fp32", 128 * 257, 1024, "float32"),
                 ("contrastive_text_bf16", 256 * 77, 512, "bfloat16"),
                 ("eva02_mlp_ln_bf16", 64 * 257, 2730, "bfloat16"),
                 ("convnext_eval_stem_fp32", 16 * 64 * 64, 128, "float32"),
                 ("vitamin_eval_stem_fp32", 16 * 112 * 112, 160, "float32")]
LN_BWD_MAIN_SHAPE = "fare_vith_bf16"
# untimed: (group_len, groups, causal) x head widths through the attention
# backward, and LayerNorm widths x rows through its backward
BWD_SWEEP = [(16, 8, True), (48, 2, True), (77, 1, True), (13, 3, False),
             (257, 1, False), (130, 1, True), (729, 1, False)]
BWD_SWEEP_HEAD_WIDTHS = {"bfloat16": (8, 32, 64, 72, 80, 128),
                         "float32": (5, 32, 64, 80, 128)}
LN_BWD_SWEEP_D = (8, 128, 160, 768, 1025, 2730, 4096, 8192)
LN_BWD_SWEEP_M = (1, 333)
GRAD_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}   # of the largest
# the forward's log-sum-exp against the plain one's (fp32 logits in both
# dtypes), of the largest
LSE_TOLERANCE = 1e-5
# `max_whole` that sends every attention backward block through the ring of
# two 64-row chunks, timed and held equal to staging whole in (c)
RING_WHOLE = 16
# published peaks of one H100 SXM (dense, at a 700 W limit): device memory
# rate; bf16 on the tensor cores; fp32 products on the tensor cores as three
# TF32 products each ("3xtf32": 495 / 3 TFLOP/s), what both attention
# kernels, the fused block and its GEMM run in fp32; fp32 outside the tensor
# cores (the LayerNorm, bound by its bytes)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
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


# (j) to (p) run the full-width towers cut in depth, so that the script stays
# well inside its time limit: (registry name, vision layers, text layers).
# Every block keeps its shape, so (c)'s rows stay the shapes these paths
# give the kernels, and the launches are held to the cut depths.  (d) to (h)
# run ViT-L-14-quickgelu at its full depth, (n) ViT-B-32 and (q) CoCa's
# coca_ViT-B-32 too.  The vision towers ran 8 layers until phase (w) needed
# the room
DEPTH_CUTS = (("ViT-L-14", 4, 4), ("ViT-L-14-quickgelu", 4, 4),
              ("ViT-H-14", 4, 6))
# to make room for (v), (r) runs SO400M (27 + 27 layers) and (q) its
# coca_ViT-L-14 (24 vision, 12 text, 12 decoder layers) cut in depth too:
# (registry name, vision, text[, decoder] layers)
ZOO_DEPTH_CUTS = (("ViT-SO400M-14-SigLIP-384", 9, 9),)
COCA_DEPTH_CUTS = (("coca_ViT-L-14", 8, 4, 4),)


@contextlib.contextmanager
def _depth_cut(cuts=DEPTH_CUTS, label: str = "(j)-(p)"):
    """The registry's configs named in `cuts`, cut to those depths for the
    duration of the block (every entry point reads the registry when it
    builds a model), then restored."""
    import dataclasses
    from leaf_tpu_torch.models import config
    saved = {name: config._REGISTRY[name] for name, _, _ in cuts}
    for name, vision_layers, text_layers in cuts:
        cfg = saved[name]
        config._REGISTRY[name] = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=vision_layers),
            text=dataclasses.replace(cfg.text, layers=text_layers))
    say(f"{label} depths cut (name, vision layers, text layers): "
        f"{[(n, saved[n].vision.layers, saved[n].text.layers) for n in saved]}"
        f" -> {list(cuts)}")
    try:
        yield
    finally:
        config._REGISTRY.update(saved)


@contextlib.contextmanager
def _coca_depth_cut():
    """The CoCa registry's configs named in `COCA_DEPTH_CUTS` cut to those
    depths for the block, as `_depth_cut`; the decoder keeps its width."""
    import dataclasses
    from leaf_tpu_torch.models import coca
    saved = {name: coca.COCA_CONFIGS[name] for name, *_ in COCA_DEPTH_CUTS}
    for name, vision, text, decoder in COCA_DEPTH_CUTS:
        cfg = saved[name]()
        cut = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, layers=vision),
            text=dataclasses.replace(cfg.text, layers=text),
            multimodal=dataclasses.replace(cfg.multimodal, layers=decoder))
        coca.COCA_CONFIGS[name] = lambda cut=cut: cut
    say(f"(q) depths cut (name, vision, text, decoder layers): "
        f"{list(COCA_DEPTH_CUTS)}")
    try:
        yield
    finally:
        coca.COCA_CONFIGS.update(saved)


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


def _bound(n_bytes: float, flops: float, peak: str):
    """The least time (ms) the card could take: the bytes the function
    must move (inputs read once, outputs written once) over the memory
    rate, or its operations over the peak rate `PEAK_FLOPS[peak]` for the
    inputs' type and the units that run them, whichever is larger, and
    which of the two it is."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _visible_pairs(L: int, group_len: int, causal: bool) -> int:
    """(query, key) pairs of one row of L tokens that attention computes."""
    pairs = 0
    for g0 in range(0, L, group_len):
        n = min(group_len, L - g0)
        pairs += n * (n + 1) // 2 if causal else n * n
    return pairs


def _schedule(L: int, group_len: int, causal: bool, allow_exact: bool = True,
              dtype_name: str = "bfloat16"):
    """The tensor-core kernel's schedule for a row in a dtype, from the
    built library, after holding the package's Python mirror of it equal."""
    import torch
    from leaf_tpu_torch.ops import packed_attention as pa
    args = (L, group_len, causal, allow_exact, getattr(torch, dtype_name))
    built, mirror = pa.kernel_schedule(*args), pa.tile_schedule(*args)
    require(built == mirror, f"tile_schedule{args} is not the library's "
            f"schedule: {mirror[0]} against {built[0]}")
    return built


def _visible_share(L: int, group_len: int, causal: bool,
                   allow_exact: bool = True,
                   dtype_name: str = "bfloat16") -> float:
    """Share of the logits the tensor-core kernel computes (16 queries x
    the key steps of every tile, by the library's own schedule) that
    attention needs.  Derived from the shape, not measured: it goes into
    the phase's printed line and not into the kernels' report."""
    from leaf_tpu_torch.ops.packed_attention import TILE
    _, tiles = _schedule(L, group_len, causal, allow_exact, dtype_name)
    computed = sum(TILE * (hi - lo)
                   for _, _, spans in tiles for lo, hi in spans)
    return _visible_pairs(L, group_len, causal) / computed


def _row(name, shape, dt, err, ms, pms, lib_ms, n_bytes, flops,
         visible_share=None, peak=None, **extra):
    """One (c) row, printed and returned.  `peak`: the `PEAK_FLOPS` key of
    the units that run the kernel's products (default: `dt`).  A kernel
    time below its bound fails the phase: the bound's count or rate would
    be wrong (the device-only time too where the operations bound it; a
    bound by bytes is no floor for data that stays in the L2 cache between
    the graph's replays)."""
    bound_ms, bound_by = _bound(n_bytes, flops, peak or dt)
    require(ms >= bound_ms, f"{name} {shape} {dt}: {ms} ms is below its "
            f"bound {bound_ms} ms by {bound_by}")
    if "device_ms" in extra and bound_by == "operations":
        require(extra["device_ms"] >= bound_ms,
                f"{name} {shape} {dt}: {extra['device_ms']} ms on the device "
                f"is below its bound {bound_ms} ms by operations")
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
        for name, R, L, S, causal, D, H, dt in SHAPES + TP_SHAPES:
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
            # both dtypes' products run on the tensor cores
            peak = "3xtf32" if dt == "float32" else dt
            err, ms, pms, lib = _compare(
                lambda: pa.packed_attention(qkv, H, S, causal),
                lambda: pa._reference(qkv, H, S, causal), dt, sdpa)
            rows["packed_attention"].append(_row(
                "packed_attention", name, dt, err, ms, pms, lib,
                4.0 * R * L * D * esize, attn_flops, R=R, L=L, group_len=S,
                causal=causal, D=D, heads=H, peak=peak,
                visible_share=_visible_share(L, S, causal, dtype_name=dt)))
            if (name, R, L, S, causal, D, H, dt) in TP_SHAPES:
                continue      # the split block runs no fused block

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
                causal=causal, D=D, heads=H, peak=peak, device_ms=_graph_ms(
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
                # both dtypes' products run on the tensor cores
                rows["flash_attention"].append(_row(
                    "flash_attention", name, dt, err, ms, pms, lib,
                    4.0 * B * H * S * d * esize,
                    4.0 * d * _visible_pairs(S, S, causal) * B * H,
                    B=B, heads=H, S=S, d=d, causal=causal,
                    peak="3xtf32" if dt == "float32" else dt,
                    visible_share=_visible_share(S, S, causal, False, dt),
                    device_ms=_graph_ms(
                        lambda: fa.flash_attention(q, k, v, causal=causal))))

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
    parts.update(_timed("c backward", phase_backward))
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
        # fp32 runs as 3xTF32 on the tensor cores; the library call is
        # torch.addmm, TF32 off
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
            residual=False, tflops=2.0 * M * N * K / ms / 1e9, peak="3xtf32",
            device_ms=_graph_ms(lambda: pa._launch_gemm_bias(a, w, b))))

    ln_shapes = [(name, R * L, D, dt) for name, R, L, _, _, D, _, dt
                 in SHAPES if name != "text_s16_fp32"]   # fp32: bucket 77
    for name, M, D, dt in ln_shapes + LN_SHAPES:
        dtype = getattr(torch, dt)
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
        plan = _ln_plan(D, dt)
        say(f"(c) layer_norm {name}: plan {plan}")
        parts["layer_norm"].append(_row(
            "layer_norm", name, dt, err, ms, pms, lib,
            2.0 * M * D * x.element_size() + 8 * D, 8.0 * M * D, M=M, D=D,
            variant=plan["variant"],
            device_ms=_graph_ms(lambda: pa.layer_norm(x, scale, bias, 1e-5))))
    return parts


def _ln_plan(D: int, dtype_name: str, aligned: bool = True) -> dict:
    """The LayerNorm kernel's plan for rows of D elements, from the built
    library, after holding the package's Python mirror of it equal."""
    import torch
    from leaf_tpu_torch.ops import packed_attention as pa
    args = (D, getattr(torch, dtype_name), aligned)
    built, mirror = pa.kernel_layer_norm_plan(*args), pa.layer_norm_plan(*args)
    require(built == mirror, f"layer_norm_plan{args} is not the library's "
            f"plan: {mirror} against {built}")
    return built


# (group_len, groups per row, causal): groups that straddle the 16-query
# tiles, every text bucket, the vision tower's 257 = 16 x 16 + 1 tokens, and
# rows too long to stage whole (the ring of 64-key stages); the zoo's
# non-causal text rows (SigLIP's 2 x 64 and 8 x 16, MobileCLIP-S2's 77)
PACKED_SWEEP = [(13, 3, False), (13, 3, True), (16, 8, True), (24, 5, True),
                (32, 4, True), (48, 2, True), (64, 2, True), (77, 1, True),
                (80, 1, False), (257, 1, False), (200, 3, False),
                (401, 1, True), (64, 2, False), (16, 8, False),
                (77, 1, False)]
SWEEP_HEAD_WIDTHS = (64, 72, 80)
# fp32 (3xTF32) also at the narrowest and the widest head, and words that are
# no 16-byte piece (the word-by-word copies)
SWEEP_HEAD_WIDTHS_FP32 = SWEEP_HEAD_WIDTHS + (8, 128, 12, 5)
# the fp32 GEMM beside the ragged shapes: PEZ's one prompt, M = 77
PEZ_GEMM_SHAPES = [("pez qkv", 77, 768, 2304), ("pez out", 77, 768, 768)]
FLASH_SWEEP_S = (1, 15, 16, 17, 63, 65, 130, 257, 600)
FLASH_SWEEP_D = (8, 40, 64, 72, 80, 128)
# the LayerNorm at every plan: narrow rows (whole pieces, fewer than 32), the
# rows kernel (768, 1000, 1024), rows of words (1025 fp32, 2730) and of bf16
# elements (1025), wide rows on a warp (1152 to 2048) and on two warps (4096
# fp32); ragged numbers of rows, none a multiple of a block's
LN_SWEEP_D = (8, 24, 128, 160, 200, 768, 1000, 1024, 1025, 1152, 1280, 1664,
              2048, 2730, 4096)
LN_SWEEP_M = (1, 7, 333)


def phase_sweep():
    """Correctness only: ragged shapes through both tensor-core kernels
    (the packed one in bf16 and fp32), the fp32 GEMM at ragged shapes,
    then the gradients of one shape of each."""
    import torch
    from leaf_tpu_torch.ops import flash_attention as fa
    from leaf_tpu_torch.ops import packed_attention as pa

    def normal(rng, *shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to("cuda", dtype)

    rng = np.random.default_rng(6)
    with torch.inference_mode():
        for dt, widths in (("bfloat16", SWEEP_HEAD_WIDTHS),
                           ("float32", SWEEP_HEAD_WIDTHS_FP32)):
            worst, cases = 0.0, 0
            dtype = getattr(torch, dt)
            for S, G, causal in PACKED_SWEEP:
                for hd in widths:
                    R, H = 3, 3
                    _schedule(G * S, S, causal, dtype_name=dt)
                    qkv = normal(rng, R, G * S, 3 * H * hd, dtype=dtype)
                    worst = max(worst, _close(
                        pa.packed_attention(qkv, H, S, causal),
                        pa._reference(qkv, H, S, causal),
                        f"packed_attention S={S} G={G} causal={causal} "
                        f"hd={hd} {dt}", dt))
                    cases += 1
            # ViT-H-14's rows: 16 heads of width 80 over 257 tokens, and one
            # token either side; SigLIP-384's: 16 heads of 72 over 729 tokens
            # (a last tile of 9 queries, a last stage of 25 keys), one either
            # side
            for L, hd in ((256, 80), (257, 80), (258, 80), (728, 72),
                          (729, 72), (730, 72)):
                _schedule(L, L, False, dtype_name=dt)
                qkv = normal(rng, 2, L, 3 * 16 * hd, dtype=dtype)
                worst = max(worst, _close(
                    pa.packed_attention(qkv, 16, L, False),
                    pa._reference(qkv, 16, L, False),
                    f"packed_attention L={L} 16 x {hd} {dt}", dt))
                cases += 1
            say(f"(c) sweep packed_attention {dt}: {cases} shapes "
                f"(group_len, groups, causal) in {PACKED_SWEEP} x head widths "
                f"{widths}, 16 heads of 80 at 256-258 tokens and of 72 at "
                f"728-730, max_abs_err {worst:.3g}")
        worst, cases = 0.0, 0
        for name, M, K, N in RAGGED_GEMM_SHAPES + PEZ_GEMM_SHAPES:
            a = normal(rng, M, K, dtype=torch.float32)
            w = normal(rng, K, N, dtype=torch.float32) * K ** -0.5
            b, res = (normal(rng, *s, dtype=torch.float32)
                      for s in ((N,), (M, N)))
            for r in (None, res):
                worst = max(worst, _close(
                    pa._launch_gemm_bias(a, w, b, r),
                    pa._gemm_bias_reference(a, w, b, r),
                    f"gemm_bias {name} fp32 residual={r is not None}",
                    "float32", residual=r))
                cases += 1
        say(f"(c) sweep gemm_bias float32: {cases} shapes (M, K, N) in "
            f"{[s[1:] for s in RAGGED_GEMM_SHAPES + PEZ_GEMM_SHAPES]}, with "
            f"and without the residual, max_abs_err {worst:.3g}")
        for dt in ("bfloat16", "float32"):
            worst, cases = 0.0, 0
            dtype = getattr(torch, dt)
            for S in FLASH_SWEEP_S:
                for d in FLASH_SWEEP_D:
                    for causal in (False, True):
                        _schedule(S, S, causal, False, dt)
                        q, k, v = (normal(rng, 2, 3, S, d, dtype=dtype)
                                   for _ in range(3))
                        worst = max(worst, _close(
                            fa.flash_attention(q, k, v, causal=causal),
                            fa._reference(q, k, v, d ** -0.5, causal),
                            f"flash_attention S={S} d={d} causal={causal} "
                            f"{dt}", dt))
                        cases += 1
            # head views of a token-major qkv (token stride 3D), read in place
            qkv = normal(rng, 3, 130, 3 * 4 * 40, dtype=dtype)
            worst = max(worst, _close(
                fa.mha_with_flash(qkv, 4, True),
                pa._reference(qkv, 4, 130, True),
                f"mha_with_flash S=130 d=40 {dt}", dt))
            say(f"(c) sweep flash_attention {dt}: {cases} shapes, S in "
                f"{FLASH_SWEEP_S} x d in {FLASH_SWEEP_D} x causal or not, "
                f"and mha_with_flash on strided views, max_abs_err "
                f"{worst:.3g}")
        say("(c) schedule: the Python mirror (tile_schedule) equals the "
            "library's make_plan and passes at every timed and swept shape, "
            "bf16 and fp32")
        for dt in ("bfloat16", "float32"):
            worst, plans = 0.0, set()
            dtype = getattr(torch, dt)
            for D in LN_SWEEP_D:
                plans.add(tuple(_ln_plan(D, dt).values()))
                scale = normal(rng, D, dtype=torch.float32) * 0.1 + 1
                bias = normal(rng, D, dtype=torch.float32) * 0.1
                for M in LN_SWEEP_M:
                    x = normal(rng, M, D, dtype=dtype) * 2 + 0.5
                    worst = max(worst, _close(
                        pa.layer_norm(x, scale, bias, 1e-5),
                        pa._layer_norm_reference(x, scale, bias, 1e-5),
                        f"layer_norm M={M} D={D} {dt}", dt))
            say(f"(c) sweep layer_norm {dt}: D in {LN_SWEEP_D} x M in "
                f"{LN_SWEEP_M}, {len(plans)} plans (the Python mirror equals "
                f"the library's at each), max_abs_err {worst:.3g}")

    # gradients through the public ops: the kernels forward and backward
    # (flash attention's backward still through its plain version), against
    # autograd through the plain versions; held to 2e-2 of the largest
    # gradient.  What it guards is the way through autograd: the saved
    # (strided) inputs, the kernel's output as the head of a graph, one
    # launch per forward and one backward launch (the backward kernels
    # themselves are held in `phase_backward`).
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

        def backward_launches():
            return (pa.packed_attention.backward_launches
                    + pa.layer_norm.backward_launches)

        before, before_b = launches(), backward_launches()
        got, want = grads(kernel, *leaves), grads(plain, *leaves)
        torch.cuda.synchronize()
        require(launches() == before + 1,
                f"{name}: the forward did not launch the kernel")
        require(backward_launches() == before_b + (0 if "flash" in name
                                                   else 1),
                f"{name}: the backward did not launch its kernel")
        scale = max(w.abs().max().item() for w in want)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        require(all(bool(torch.isfinite(g).all()) for g in got)
                and err <= 2e-2 * scale,
                f"{name}: gradients differ by {err} (largest {scale})")
        say(f"(c) gradient {name} bf16: max abs diff {err:.3g} (largest "
            f"gradient {scale:.3g})")


def _grad_err(got, want, what: str, dtype_name: str):
    """Hold gradients to the plain version's: max |got - want| of each
    tensor within `GRAD_TOLERANCE` of that tensor's largest |want|; returns
    (the largest absolute difference, the largest relative one)."""
    import torch
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what}: gradient {i} {tuple(g.shape)} {g.dtype} against "
                f"{tuple(w.shape)} {w.dtype}")
        require(bool(torch.isfinite(g).all()), f"{what}: gradient {i} not "
                "finite")
        d = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        abs_err, rel_err = max(abs_err, d), max(rel_err, d / max(scale, 1e-30))
    require(rel_err <= GRAD_TOLERANCE[dtype_name],
            f"{what}: gradients differ by {rel_err:.3g} of the largest "
            f"(> {GRAD_TOLERANCE[dtype_name]})")
    return abs_err, rel_err


def _turns(kernel, plain, library=None, n: int = 10):
    """(kernel ms, plain ms, library ms or None), CUDA events over `n` calls
    in turns plain, kernel, library, kernel, plain after a warm-up."""
    for fn in (kernel, plain) + ((library,) if library else ()):
        fn()
    p1, k1 = _time_ms(plain, n), _time_ms(kernel, n)
    lib = _time_ms(library, n) if library else None
    k2, p2 = _time_ms(kernel, n), _time_ms(plain, n)
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def _forward_lse(qkv, H: int, S: int, causal: bool, what: str):
    """The training forward's packed kernel at qkv (uncounted): its output,
    equal bit for bit to serving's (no log-sum-exp asked), and its
    log-sum-exp, held to the plain forward's within `LSE_TOLERANCE` of the
    largest; returns (out, lse, the largest difference over the largest)."""
    import torch
    from leaf_tpu_torch.ops import packed_attention as pa
    with torch.no_grad():
        out, lse = pa._packed_attention_kernel(qkv, H, S, causal,
                                               with_lse=True)
        serving = pa._packed_attention_kernel(qkv, H, S, causal)
        _, want = pa._reference(qkv, H, S, causal, with_lse=True)
    torch.cuda.synchronize()
    require(torch.equal(out, serving),
            f"{what}: the forward that writes the log-sum-exp gives another "
            "output")
    require(lse.shape == want.shape and bool(torch.isfinite(lse).all()),
            f"{what}: log-sum-exp {tuple(lse.shape)} not finite or not "
            f"{tuple(want.shape)}")
    err = ((lse - want).abs().max() / want.abs().max()).item()
    require(err <= LSE_TOLERANCE, f"{what}: the forward's log-sum-exp is "
            f"{err:.3g} of the largest from the plain one's")
    return out, lse, err


def phase_backward():
    """(c) the backward kernels against their plain versions: the attention
    backward (`leaf_packed_attention_backward`, from the log-sum-exp that
    the training forward's packed kernel writes, itself held to the plain
    log-sum-exp) and the LayerNorm backward at the differentiated paths'
    shapes, timed (kernel, plain version, the library's backward: SDPA's,
    `F.layer_norm`'s; the attention's also through the ring of 64-row
    chunks, `RING_WHOLE`, equal bit for bit to staging whole) and held to
    autograd through the plain forward and to the explicit plain backward,
    two runs equal bit for bit, the schedule and the plan equal to their
    Python mirrors; the fused block's backward (all gradients, and the
    input's alone) against autograd through `_block_reference`; then an
    untimed sweep of head widths, groups and LayerNorm widths."""
    import torch
    from torch.nn import functional as F
    from leaf_tpu_torch.ops import packed_attention as pa
    rows = {"packed_attention_backward": [], "layer_norm_backward": [],
            "fused_attention_block_backward": []}
    g = torch.Generator(device="cuda").manual_seed(0)

    def dev(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device="cuda") * scale
                + shift).to(dtype)

    def autograd(fn, leaves, grad_out):
        ts = [t.detach().clone().requires_grad_() for t in leaves]
        return list(torch.autograd.grad(fn(*ts), ts, grad_out))

    for name, R, L, S, causal, D, H, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        esize, hd = (2 if dt == "bfloat16" else 4), D // H
        for max_whole in (0, RING_WHOLE):
            require(pa.kernel_backward_schedule(L, S, causal, dtype, max_whole)
                    == pa.backward_schedule(L, S, causal, dtype, max_whole),
                    f"backward_schedule({L}, {S}, {causal}, {dt}, "
                    f"{max_whole}) is not the library's")
        qkv = dev(R, L, 3 * D, dtype=dtype)
        dout = dev(R, L, D, dtype=dtype)
        out, lse, lse_err = _forward_lse(qkv, H, S, causal, f"{name}")

        def kernel(qkv=qkv, out=out, lse=lse, dout=dout, max_whole=0):
            return pa._launch_packed_attention_backward(
                qkv, out, lse, dout, H, S, causal, max_whole)

        def ring(kernel=kernel):
            return kernel(max_whole=RING_WHOLE)

        def plain(qkv=qkv, out=out, lse=lse, dout=dout):
            return pa._packed_attention_backward_reference(qkv, out, lse,
                                                           dout, H, S, causal)

        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        require(torch.equal(got, again),
                f"attention backward {name}: two runs differ")
        require(torch.equal(got, ring()),
                f"attention backward {name}: the ring differs from staging "
                "whole")
        want = autograd(lambda t: pa._reference(t, H, S, causal), [qkv],
                        dout)
        err, rel = _grad_err([got], want, f"attention backward {name} "
                             "against autograd through the plain forward", dt)
        _grad_err([got], [plain()], f"attention backward {name} against the "
                  "plain backward", dt)
        del want
        mask = pa.block_mask(L, S, causal, "cuda")
        lq = qkv.detach().clone().requires_grad_()
        q, k, v = (t.reshape(R, L, H, hd).transpose(1, 2)
                   for t in lq.split(D, dim=-1))
        sdpa = F.scaled_dot_product_attention(
            q, k, v, attn_mask=None if S == L else mask,
            is_causal=causal and S == L)
        sdpa_g = dout.reshape(R, L, H, hd).transpose(1, 2)

        def library(sdpa=sdpa, lq=lq, sdpa_g=sdpa_g):
            return torch.autograd.grad(sdpa, lq, sdpa_g, retain_graph=True)

        lib_err = (library()[0].float() - got.float()).abs().max().item()
        require(lib_err <= 0.1 * got.float().abs().max().item() + 1e-3,
                f"attention backward {name}: SDPA's backward computes "
                f"another function ({lib_err})")
        ms, pms, lib = _turns(kernel, plain, library)
        ring_ms = (_time_ms(ring, 10) + _time_ms(ring, 10)) / 2

        def recompute(qkv=qkv, dout=dout):
            return autograd(lambda t: pa._reference(t, H, S, causal), [qkv],
                            dout)
        recompute_ms = _time_ms(recompute, 3)
        pairs = _visible_pairs(L, S, causal) * H * R
        sched = pa.backward_schedule(L, S, causal, dtype)
        rows["packed_attention_backward"].append(_row(
            "packed_attention backward", name, dt, err, ms, pms, lib,
            8.0 * R * L * D * esize + 4.0 * R * H * L, 10.0 * hd * pairs,
            R=R, L=L, group_len=S, causal=causal, D=D, heads=H, rel_err=rel,
            recompute_ms=recompute_ms, ring_ms=ring_ms, lse_err=lse_err,
            plan={k: sched[k] for k in ("warps", "blocks", "dq_whole",
                                        "dkv_whole")},
            peak="bfloat16" if dt == "bfloat16" else "3xtf32"))
        say(f"(c) packed_attention backward {name}: plan "
            f"{rows['packed_attention_backward'][-1]['plan']}; through the "
            f"ring of {pa.BWD_CHUNK}-row chunks {ring_ms:.4f} ms "
            f"(the same bits); autograd through the plain forward (the "
            f"backward before) {recompute_ms:.4f} ms; largest difference "
            f"{rel:.3g} of the largest gradient; two runs equal bit for bit; "
            f"the forward's log-sum-exp within {lse_err:.3g} of the plain "
            "one's largest")
        del sdpa, lq, q, k, v, got, again
        torch.cuda.empty_cache()

        if name not in BLOCK_BWD_SHAPES:
            continue
        x = dev(R, L, D, scale=0.5, dtype=dtype)
        gx = dev(R, L, D, dtype=dtype)
        p = {"ln_1": {"scale": dev(D, scale=0.1, shift=1.0),
                      "bias": dev(D, scale=0.1)},
             "attn": {"qkv_w": dev(D, 3 * D, scale=D ** -0.5, dtype=dtype),
                      "qkv_b": dev(3 * D, scale=0.1, dtype=dtype),
                      "out_w": dev(D, D, scale=D ** -0.5, dtype=dtype),
                      "out_b": dev(D, scale=0.1, dtype=dtype)}}
        leaves = [p[a][b] for a, b in pa._BLOCK_KEYS]

        def tree(ts):
            return {"ln_1": dict(zip(("scale", "bias"), ts[:2])),
                    "attn": dict(zip(("qkv_w", "qkv_b", "out_w", "out_b"),
                                     ts[2:]))}

        for mode in ("all", "input"):
            n_in = 7 if mode == "all" else 1
            ts = [t.detach().clone().requires_grad_(i < n_in)
                  for i, t in enumerate([x] + leaves)]
            out_k = pa.fused_attention_block(tree(ts[1:]), ts[0], H, S, causal)
            ps = [t.detach().clone().requires_grad_(i < n_in)
                  for i, t in enumerate([x] + leaves)]
            before = pa.fused_attention_block.backward_launches

            def kernel(out_k=out_k, ts=ts, n_in=n_in):
                return torch.autograd.grad(out_k, ts[:n_in], gx,
                                           retain_graph=True)

            def plain(ps=ps, n_in=n_in):
                # the backward before: the plain block again, and autograd
                # through it
                return torch.autograd.grad(
                    pa._block_reference(tree(ps[1:]), ps[0], H, S, causal,
                                        1e-5), ps[:n_in], gx)

            got = kernel()
            require(pa.fused_attention_block.backward_launches == before + 1,
                    f"block backward {name}: no launch")
            err, rel = _grad_err(got, plain(), f"block backward {name} "
                                 f"{mode}", dt)
            same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
            ms, pms, _ = _turns(kernel, plain, n=5)
            M = R * L
            products = (16.0 if mode == "all" else 8.0) * M * D * D
            n_bytes = (3.0 * M * D + (8 * D * D + 8 * D if mode == "all"
                                      else 4 * D * D)) * esize + 16 * D
            rows["fused_attention_block_backward"].append(_row(
                "fused_attention_block backward", f"{name} {mode}", dt, err,
                ms, pms, None, n_bytes,
                products + 10.0 * hd * _visible_pairs(L, S, causal) * H * R,
                R=R, L=L, group_len=S, causal=causal, D=D, heads=H,
                rel_err=rel, same_bits=same, gradients=mode,
                peak="bfloat16" if dt == "bfloat16" else "float32"))
            say(f"(c) fused_attention_block backward {name} ({mode}): largest "
                f"difference {rel:.3g} of the largest gradient; two runs "
                f"{'equal' if same else 'differ (cuBLAS)'} bit for bit")
            del out_k, ts, ps, got
        torch.cuda.empty_cache()

    for name, M, D, dt in LN_BWD_SHAPES:
        dtype = getattr(torch, dt)
        esize = 2 if dt == "bfloat16" else 4
        plan = pa.kernel_layer_norm_backward_plan(M, D, dtype)
        require(plan == pa.layer_norm_backward_plan(M, D, dtype),
                f"layer_norm_backward_plan({M}, {D}, {dt}) is not the "
                f"library's plan {plan}")
        x = dev(M, D, scale=2.0, shift=0.5, dtype=dtype)
        dy = dev(M, D, dtype=dtype)
        # fp32 parameters that bf16 holds exactly (the library call takes
        # them in x's dtype)
        scale = dev(D, scale=0.1, shift=1.0).to(dtype).float()
        bias = dev(D, scale=0.1).to(dtype).float()

        def kernel(x=x, scale=scale, dy=dy):
            return pa._launch_layer_norm_backward(x, scale, dy, 1e-5, True)

        def plain(x=x, scale=scale, bias=bias, dy=dy):
            return pa._layer_norm_backward_reference(x, scale, bias, 1e-5, dy)

        got, again = kernel(), kernel()
        dx_alone = pa._launch_layer_norm_backward(x, scale, dy, 1e-5, False)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again))
                and torch.equal(got[0], dx_alone[0]),
                f"layer_norm backward {name}: two runs differ")
        want = autograd(lambda *t: pa._layer_norm_reference(*t, 1e-5),
                        [x, scale, bias], dy)
        err, rel = _grad_err(list(got), want, f"layer_norm backward {name}",
                             dt)
        _grad_err(list(got), list(plain()), f"layer_norm backward {name} "
                  "against the plain backward", dt)
        lx = x.detach().clone().requires_grad_()
        lw, lb = (t.to(dtype).detach().clone().requires_grad_()
                  for t in (scale, bias))
        ly = F.layer_norm(lx, (D,), lw, lb, 1e-5)

        def library(ly=ly, lx=lx, lw=lw, lb=lb, dy=dy):
            return torch.autograd.grad(ly, (lx, lw, lb), dy,
                                       retain_graph=True)

        ms, pms, lib = _turns(kernel, plain, library)
        rows["layer_norm_backward"].append(_row(
            "layer_norm backward", name, dt, err, ms, pms, lib,
            3.0 * M * D * esize + 12 * D, 12.0 * M * D, M=M, D=D,
            rel_err=rel, plan=plan,
            dx_alone_ms=_time_ms(lambda: pa._launch_layer_norm_backward(
                x, scale, dy, 1e-5, False)), peak="float32"))
        del ly, lx, lw, lb, got, again, want
    torch.cuda.empty_cache()

    rng = np.random.default_rng(8)
    for dt, widths in BWD_SWEEP_HEAD_WIDTHS.items():
        dtype, worst, cases = getattr(torch, dt), 0.0, 0
        for S, G, causal in BWD_SWEEP:
            for hd in widths:
                L, H = G * S, 2
                qkv = torch.from_numpy(rng.standard_normal(
                    (2, L, 3 * H * hd)).astype(np.float32)).to("cuda", dtype)
                dout = torch.from_numpy(rng.standard_normal(
                    (2, L, H * hd)).astype(np.float32)).to("cuda", dtype)
                what = f"S={S} G={G} causal={causal} hd={hd} {dt}"
                out, lse, _ = _forward_lse(qkv, H, S, causal, what)
                got = pa._launch_packed_attention_backward(qkv, out, lse,
                                                           dout, H, S, causal)
                require(torch.equal(got, pa._launch_packed_attention_backward(
                    qkv, out, lse, dout, H, S, causal, RING_WHOLE)),
                    f"attention backward {what}: the ring differs")
                want = autograd(lambda t: pa._reference(t, H, S, causal),
                                [qkv], dout)
                worst = max(worst, _grad_err(
                    [got], want, f"attention backward S={S} G={G} "
                    f"causal={causal} hd={hd} {dt}", dt)[1])
                cases += 1
        say(f"(c) sweep packed_attention backward {dt}: {cases} shapes "
            f"(group_len, groups, causal) in {BWD_SWEEP} x head widths "
            f"{widths}, largest difference {worst:.3g} of the largest "
            "gradient; the forward's log-sum-exp held to the plain one's, "
            "the ring equal to staging whole at each")
    for dt in ("bfloat16", "float32"):
        dtype, worst = getattr(torch, dt), 0.0
        for D in LN_BWD_SWEEP_D:
            for M in LN_BWD_SWEEP_M:
                require(pa.kernel_layer_norm_backward_plan(M, D, dtype)
                        == pa.layer_norm_backward_plan(M, D, dtype),
                        f"layer_norm_backward_plan({M}, {D}, {dt})")
                x, dy = (torch.from_numpy(rng.standard_normal((M, D)).astype(
                    np.float32)).to("cuda", dtype) for _ in range(2))
                scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(D))
                                         .astype(np.float32)).cuda()
                bias = torch.zeros_like(scale)
                got = pa._launch_layer_norm_backward(x, scale, dy, 1e-5, True)
                want = autograd(lambda *t: pa._layer_norm_reference(*t, 1e-5),
                                [x, scale, bias], dy)
                worst = max(worst, _grad_err(
                    list(got), want, f"layer_norm backward M={M} D={D} {dt}",
                    dt)[1])
        say(f"(c) sweep layer_norm backward {dt}: D in {LN_BWD_SWEEP_D} x M "
            f"in {LN_BWD_SWEEP_M} (the plan's Python mirror equal to the "
            f"library's at each), largest difference {worst:.3g} of the "
            "largest gradient")
    return rows


# ---------------------------------------------------------------------------
# The guard of the differentiated phases
# ---------------------------------------------------------------------------

BACKWARD_NAMES = ("packed_attention", "layer_norm", "fused_attention_block")
# each guarded phase's backward launches and plain calls on the card
BACKWARD = {}
# the backward counts of rank processes, as `_v_wait` reads them
RANK_BACKWARD = []


def _backward_counts() -> dict:
    """This process's backward launches and plain-version calls on a CUDA
    tensor, for a rank to report."""
    from leaf_tpu_torch.ops import packed_attention as pa
    return {"plain_on_cuda": pa.PLAIN_ON_CUDA["calls"],
            **{n: getattr(pa, n).backward_launches for n in BACKWARD_NAMES}}


class _BackwardGuard:
    """Around a phase whose steps differentiate the towers: no plain version
    runs on a CUDA tensor from entry to exit (`PLAIN_ON_CUDA` stays 0, in
    this process and in the rank processes it reads), and the backward
    kernels launch: their launches over the phase are kept in `BACKWARD`,
    the attention's and the LayerNorm's nonzero."""

    def __init__(self, tag: str):
        self.tag = tag

    def __enter__(self):
        from leaf_tpu_torch.ops import packed_attention as pa
        pa.PLAIN_ON_CUDA["calls"] = 0
        self.before = _backward_counts()
        self.ranks = len(RANK_BACKWARD)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        import torch
        torch.cuda.synchronize()
        after = _backward_counts()
        got = {k: after[k] - self.before[k] for k in after}
        got["plain_on_cuda"] = after["plain_on_cuda"]
        for rank in RANK_BACKWARD[self.ranks:]:
            for k in got:
                got[k] += rank[k]
        say(f"({self.tag}) backward launches {got}: no plain version ran on "
            "the card")
        require(got["plain_on_cuda"] == 0,
                f"({self.tag}) {got['plain_on_cuda']} calls of a plain version "
                "on a CUDA tensor")
        require(got["packed_attention"] > 0 and got["layer_norm"] > 0,
                f"({self.tag}) the backward kernels did not launch: {got}")
        BACKWARD[self.tag] = got
        return False


# ---------------------------------------------------------------------------
# (d), (e) the serving path
# ---------------------------------------------------------------------------

def _captions(rng, n: int, lo: int, hi: int):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


class _Rates(logging.Handler):
    """Keeps the (count, seconds, rate) arguments of serve's "text:" and
    "image:" log lines."""

    def __init__(self):
        super().__init__()
        self.text, self.image = [], []

    def emit(self, record):
        for kind in ("text", "image"):
            if record.getMessage().startswith(kind + ":"):
                getattr(self, kind).append(record.args)


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
    what `seconds` (running totals of the unfused attack's host and device
    seconds, or the fused step's host seconds) held then."""

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


def _fused_waits(spans):
    """From the spans of a recording (`utils.tracing`) over fused steps:
    the seconds each step waited for its best-probe readbacks
    (`train.fused.wait`), in step order, and how many of the pipelined
    steps' first readbacks returned while the second half's phase 1 still
    ran ("early") and after it ("late")."""
    steps = [i for i, s in enumerate(spans) if s.name == "train.fused.step"]
    waits, early, late = [0.0] * len(steps), 0, 0
    for s in spans:
        if s.name != "train.fused.wait":
            continue
        root = s.parent
        while spans[root].name != "train.fused.step":
            root = spans[root].parent
        waits[steps.index(root)] += s.ms / 1e3
        if "early" in s.counts:
            early += s.counts["early"]
            late += 1 - s.counts["early"]
    return waits, early, late


def _report_fused(tag, steps, host_s, spans):
    """Print rates of the fused loop's `steps` and, from the fused step's
    host seconds over them (`host_s`) and the spans recorded over them,
    the host's preparation and waiting seconds per step and where the
    first readbacks returned."""
    step_s, out = _step_times(tag, steps)
    n = len(steps)
    host_s = host_s / n
    waits, early, late = _fused_waits(spans)
    wait_s = sum(waits) / n
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
    from leaf_tpu_torch.utils import tracing

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
        with tracing.recording():
            out = driver.main(TRAIN_FLAGS + ["--logs", workdir, "--name",
                                             "free"])
        cfg, layers = out["cfg"], out["cfg"].text.layers
        fs = out["fused_step"]
        # per step: 2 probe + 2 candidate scoring encodes and the train
        # forward's 2 half encodes (its backward runs the backward kernels,
        # held by the phase's guard); the caption is the same in
        # every row, so only the first step's first half encodes anchors
        counters.hold("train.driver fused, 'Dummy caption'", 6 * n_steps + 1,
                      layers, f"{n_steps} steps x (2 probe + 2 candidate + 2 "
                      "train-forward half encodes) + 1 anchor encode, the "
                      "cache hit ever after")
        results["fused_s16"] = _report_fused(
            "train.driver fused, caption 'Dummy caption' (bucket 16)",
            handler.steps, fs.seconds["host"], tracing.recorded())
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
            """One epoch of the loop over caption batches, its spans
            recorded; returns the unfused attack's host/device seconds and
            the loader."""
            handler.steps.clear()
            seconds = {"host": 0.0, "device": 0.0}
            watched = fused_step.seconds if fused_step is not None else seconds
            loader = _CaptionBatches(batches, watched)
            data = {"train": DataInfo(loader, num_batches=len(batches),
                                      num_samples=BATCH * len(batches))}
            counters.zero()
            with tracing.recording():
                loop.train_one_epoch_text_only(
                    state, frozen_text, scorer, step.make_anchor_encode(),
                    step.make_train_step(), tok, edits.DEFAULT_VOCAB, data,
                    epoch, args, constraint=constraint,
                    rng=np.random.default_rng(seed), seconds=seconds,
                    fused_step=fused_step)
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
            with tracing.recording():
                out = driver.main(TRAIN_FLAGS + [
                    "--constrain", "--logs", workdir, "--name",
                    "constrained"] + extra)
            fs = out["fused_step"]
            counters.hold(f"train.driver fused --constrain, leg {leg + 1}",
                          6 * n_steps + 1, layers,
                          f"{n_steps} steps x 6 half encodes + 1 anchor encode")
            results[f"constrained_s16_leg{leg + 1}"] = _report_fused(
                "train.driver fused --constrain, caption 'Dummy caption', "
                + ("epoch 1" if leg == 0 else "--resume latest, epoch 2"),
                handler.steps, fs.seconds["host"], tracing.recorded())
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
            before = fs.seconds["host"]
            misses = _anchor_misses(batches, cache)
            _, loader = run_loop(batches, epoch, 5, fused_step=fs,
                                 constraint=fs.constraint)
            spans = tracing.recorded()
            counters.hold(tag, 6 * len(batches) + misses, layers,
                          f"{len(batches)} steps x 6 half encodes + {misses} "
                          "anchor encodes of halves that missed the cache")
            waits = _fused_waits(spans)[0]
            for i, (bucket, a) in enumerate(zip((16, 32, 48, 64),
                                                handler.steps)):
                host = loader.marks[i + 1]["host"] - loader.marks[i]["host"]
                say(f"(j) {tag}, bucket {bucket}: step {a[5]:.3f} s, host "
                    f"preparation {host:.3f} s, waited {waits[i]:.3f} s, "
                    f"loss {a[8]:.4f}")
            return _report_fused(tag + " (buckets 16-64)", handler.steps,
                                 fs.seconds["host"] - before, spans)

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
    (depth cut, `DEPTH_CUTS`), the kernels' launches held during each eval; then the fused
    and the unfused loop over the same tar set, one epoch each, no evals."""
    import torch
    from leaf_tpu_torch.attacks import edits
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.data import get_data
    from leaf_tpu_torch.models.factory import get_tokenizer
    from leaf_tpu_torch.train import driver, fused, loop, params, step
    from leaf_tpu_torch.utils import tracing

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
            before = fs.seconds["host"]
            counters.zero()
            with tracing.recording():
                loop.train_one_epoch_text_only(
                    state, frozen, scorer, step.make_anchor_encode(),
                    step.make_train_step(), tok, edits.DEFAULT_VOCAB, data,
                    epoch, args,
                    rng=np.random.default_rng(13), seconds=seconds,
                    fused_step=fused_step)
            torch.cuda.synchronize()
            name = f"{tag} loop, recipe tar set (unique captions of 3-58 words)"
            loops[tag] = (_report_fused(name, handler.steps,
                                        fs.seconds["host"] - before,
                                        tracing.recorded())
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
    `layers`: the towers' depths (`MODEL`'s in the registry by default)."""

    def __init__(self, counters, tag: str, out: dict, layers=None,
                 phase: str = "l"):
        from leaf_tpu_torch.models.config import get_model_config
        self.counters, self.tag, self.out = counters, tag, out
        cfg = get_model_config(MODEL)
        self.layers = layers or {"text": cfg.text.layers,
                                 "image": cfg.vision.layers}
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

        depth = dict.fromkeys(self.clock, 0)

        def timed(inner, kind):
            # a timed call inside another of its kind counts once
            # (`create_model_and_transforms` calls `create_model`)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                depth[kind] += 1
                try:
                    return inner(*args, **kwargs)
                finally:
                    depth[kind] -= 1
                    if not depth[kind]:
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
        # train.driver imported its own name
        for module, name in ((factory, "create_model"),
                             (driver, "create_model_and_transforms")):
            self.saved.append((module, name, getattr(module, name)))
            setattr(module, name, timed(getattr(module, name), "build"))
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
    full width (depth cut, `DEPTH_CUTS`; random weights, seed 0), each
    part through its command line's `main`, on the card."""
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
FARE_IMAGES, FARE_CLASSES, FARE_STEPS = 256, 8, 1
ROBUST_IMAGES = 32
# scripts/train_fare_vith.sh's flags, but for the schedule: 1 step (3 until
# phase (u) needed the room) where the recipe warms up for 700 of its 10,000
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
    (twice under remat: the forward and its recompute in the backward),
    `ln_2` with each block, and `ln_pre` and `ln_post` once an encode; and
    the backward kernels' (`_backward_launches`)."""
    blocks = layers * (encodes + (2 if remat else 1) * differentiated)
    return {"packed_attention": blocks, "fused_attention_block": blocks,
            "layer_norm": blocks + 2 * (encodes + differentiated),
            **_backward_launches(layers, differentiated, 2)}


def _backward_launches(blocks: int, differentiated: int, outside: int):
    """The backward launches of `differentiated` encodes of a tower of
    `blocks` fused blocks and `outside` LayerNorm ops besides the blocks'
    `ln_2`: a block backward per block, which runs the attention backward
    and `ln_1`'s; the LayerNorm backward of every `ln_2` and of the others
    (whatever the recompute of remat launched forward)."""
    return {"packed_attention backward": blocks * differentiated,
            "fused_attention_block backward": blocks * differentiated,
            "layer_norm backward": (2 * blocks + outside) * differentiated}


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
            return {**{name: op.launches
                       for name, op in self.counters.ops.items()},
                    **{f"{name} backward": op.backward_launches
                       for name, op in self.counters.ops.items()}}

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
    (depth cut, `DEPTH_CUTS`; random weights, seed 0): 1 step with remat, then 1 with
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
                    f"differentiated encodes of {layers} layers, forward and "
                    "backward)")
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
    """`imagenet_robust.main` at ViT-H-14's full width (depth cut,
    `DEPTH_CUTS`; fp32, TF32 off), the kernels' launches held to its encodes."""
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
    (the backward's kernels count apart: `_backward_launches`), `ln_2`
    with each block, `ln_final`, `ln_pre` and `ln_post` once a pass."""
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
             "make_coca_train_step", "evaluate_contrastive")

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

        for name in self.NAMES[:-1]:
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
    cfg = model.cfg
    # both towers differentiated once: ln_final, ln_pre and ln_post beside
    # the blocks
    want = {**_clip_launches(cfg, 1), **_backward_launches(
        cfg.text.layers + cfg.vision.layers, 1, 3)}
    seconds = []
    for _ in range(n):
        counters.zero()
        before = {f"{k} backward": op.backward_launches
                  for k, op in counters.ops.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, images, tokens)
        end.record()
        end.synchronize()
        got = {k: op.launches for k, op in counters.ops.items()}
        got.update({f"{k} backward": op.backward_launches - before[
            f"{k} backward"] for k, op in counters.ops.items()})
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
    seeded image-caption pairs in 8 tar shards: 2 plain steps (8 until
    phase (u), 4 until phase (v) needed the room) with `--val-data` (one
    more shard) before and after, a resume for 1 more (2 until (v)),
    then 1 step each (4 until phase (t), 2 until (v)) with `--siglip`,
    `--accum-freq 2`, `--distill-model ViT-B-32` and `--lock-image`.  Per step: the device's seconds, the
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
                        str(pairs // 4), "--epochs", "1"], 2, 1),
             ("resumed", ["--val-data", val, "--train-num-samples", "256",
                          "--epochs", "2", "--resume", "latest"], 1, 1),
             ("siglip", ["--siglip", "--train-num-samples", "256",
                         "--epochs", "1"], 1, 1),
             ("accum 2", ["--accum-freq", "2", "--train-num-samples",
                          str(pairs // 4), "--epochs", "1"], 1, 4),
             ("distill", ["--distill-model", CLIP_MODEL,
                          "--train-num-samples", "256", "--epochs", "1"],
              1, 2),
             ("lock-image", ["--lock-image", "--train-num-samples", "256",
                             "--epochs", "1"], 1, 1)]
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
            require(out["state"].step == 3 and [
                str(r["epoch"]) for r in rows] == ["0", "1", "2"],
                f"(n) resume: step {out['state'].step}, rows {rows}")
            extra_say = ", resumed at step 2 to step 3"
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
# the command line's default: 3,000; the captions' were cut from 300 to 150
# to make room for phase (t) in the script's time limit
PEZ_ITERS, PEZ_IMAGE_ITERS = 150, 100


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
                 layers=None, label: str = "(o)"):
        from leaf_tpu_torch.models.config import get_model_config
        self.counters, self.tag, self.want = counters, tag, want_encodes
        cfg = get_model_config(MODEL)
        self.layers = layers or (cfg.text.layers, cfg.vision.layers)
        self.label = label

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
    width (depth cut, `DEPTH_CUTS`; random weights, seed 0), each part's encodes and
    launches held: `cli eval` (fp32, batch 64, TF32 off) on a CIFAR-10
    pickle layout of 1,024 seeded 32 x 32 images (10 classes x 18
    templates), an imagenet1k WordNet-id folder of 8 classes with 64 `.npy`
    images (80 templates), the CIFAR set with `--precision bf16`, `--attack
    apgd --attack-iters 10` on 32 CIFAR images, a Karpathy retrieval JSON of
    64 images x 5 captions, a SugarCrepe JSON of 64 records, the linear
    probe on 8-class folders (256 / 64 images, 100 epochs) and with
    `--fewshot-k 8`; `build` and `reformat` over the JSONs; then
    `pez_driver.main` on 2 seeded captions (3-10 and 20-30 words, prompt
    length "match", 150 iterations where the default is 3,000), one image
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
    """(p) at ViT-L-14-quickgelu's full width (depth cut, `DEPTH_CUTS`;
    random weights):
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


# ---------------------------------------------------------------------------
# (q) CoCa: captioning at coca_ViT-L-14, training at coca_ViT-B-32
# ---------------------------------------------------------------------------

COCA_TINY = "coca-tiny-test"
COCA_CAPTION_MODEL, COCA_TRAIN_MODEL = "coca_ViT-L-14", "coca_ViT-B-32"
COCA_IMAGES = 64        # COCO's 5,000 Karpathy test images cut to a call
COCA_STEPS = 2     # 4 until phase (u) needed the room
COCA_FLAGS = [COCA_TRAIN_MODEL if x == CLIP_MODEL else x for x in CLIP_FLAGS]


def _coca_launches(cfg, image=0, text=0, decode=0, cache=0, step=0):
    """Launches of each packed kernel and of the LayerNorm op for CoCa's
    parts on the card.  A fused block per vision layer an image encode (the
    text tower and the decoder run unpacked, as in JAX).  The LayerNorm
    op: ln_pre, ln_2 per vision block, the pooler's ln_k and ln_q, and
    ln_post an image encode; ln_1 and ln_2 per text block and ln_final a
    text encode; per decoder layer ln_1 and ln_2 of the self block and
    ln_1, ln_1_kv and ln_2 of the cross block, and ln_final, a full decode;
    ln_1_kv per decoder layer a generation cache; a cached step ln_1 and
    ln_2 per text block, the decoder's four but ln_1_kv per layer, and
    ln_final."""
    lv, lt, lm = cfg.vision.layers, cfg.text.layers, cfg.multimodal.layers
    return {"packed_attention": lv * image,
            "fused_attention_block": lv * image,
            "layer_norm": (lv + 4) * image + (2 * lt + 1) * text
            + (5 * lm + 1) * decode + lm * cache
            + (2 * lt + 4 * lm + 1) * step}


class _CocaCalls:
    """One part of (q) on the card: CoCa's image and text encodes, full
    decodes, generation caches and cached steps counted by wrapping them
    (the calls on CUDA tensors), the image encodes timed by CUDA events,
    the kernels' counters zeroed and the memory's peak reset on entry; on
    exit the counters held to `_coca_launches` of the calls and, where
    given, the calls to `want`, and added to the counters' totals."""

    PARTS = (("CoCaVisionTower", "encode", "image"),
             ("CoCaTextTower", "encode", "text"),
             ("MultimodalDecoder", "forward", "decode"),
             (None, "init_generation_cache", "cache"),
             (None, "decode_one", "step"))

    def __init__(self, counters, cfg, tag: str, want=None):
        self.counters, self.cfg, self.tag, self.want = counters, cfg, tag, want

    def __enter__(self):
        import torch
        from leaf_tpu_torch.models import coca
        self.calls = dict.fromkeys((p[2] for p in self.PARTS), 0)
        self.events, self.saved = [], []
        part = self

        def wrap(owner, name, kind):
            inner = getattr(owner, name)

            def counted(*args, **kwargs):
                x = next(a for a in args if isinstance(a, torch.Tensor))
                if not x.is_cuda:
                    return inner(*args, **kwargs)
                part.calls[kind] += 1
                if kind != "image":
                    return inner(*args, **kwargs)
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = inner(*args, **kwargs)
                ev[1].record()
                part.events.append(ev)
                return out
            setattr(owner, name, counted)
            self.saved.append((owner, name, inner))

        for cls, name, kind in self.PARTS:
            wrap(getattr(coca, cls) if cls else coca, name, kind)
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
        for owner, name, inner in self.saved:
            setattr(owner, name, inner)
        if exc_type is not None:
            return False
        self.image_s = sum(a.elapsed_time(b) for a, b in self.events) / 1e3
        self.peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = _coca_launches(self.cfg, **self.calls)
        self.launches = {n: op.launches for n, op in self.counters.ops.items()}
        say(f"(q) {self.tag}: {self.seconds:.2f} s, peak device memory "
            f"{self.peak_gib:.1f} GiB; calls {self.calls}; launches "
            f"{self.launches} = {want}")
        if self.want is not None:
            require(all(self.calls[k] == v for k, v in self.want.items()),
                    f"(q) {self.tag}: calls {self.calls}, {self.want} "
                    "expected")
        require(self.launches == want and self.calls["image"] > 0,
                f"(q) {self.tag}: launches {self.launches}, {want} expected")
        for name in want:
            self.counters.total[name] += want[name]
        return False


def phase_coca_parity(workdir: str):
    """coca-tiny-test, fp32, TF32 off, the card against the CPU from the
    same seeded weights: the encoders, the training forward's logits and
    `coca_loss` within 1e-5; greedy and beam-search ids identical; one
    train step (lr 1e-4) leaves every parameter within 1e-5 but the
    attention key biases, whose true gradient is zero, within 2 lr (ROADMAP
    Queue 3).  The card's launches are held to its calls."""
    import torch
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models import coca
    from leaf_tpu_torch.models.factory import get_tokenizer
    from leaf_tpu_torch.models.loss import coca_loss
    from leaf_tpu_torch.train.contrastive import (ContrastiveState,
                                                  make_coca_train_step)
    from leaf_tpu_torch.train.optim import make_optimizer

    lr = 1e-4
    rng = np.random.default_rng(71)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    tokens = np.asarray(get_tokenizer(COCA_TINY)(_captions(rng, 4, 3, 10)))
    counters, runs = _Counters(), {}
    cfg = coca.get_coca_config(COCA_TINY)
    with fp32_products():
        for device in ("cpu", "cuda"):
            model = coca.create_coca_model(COCA_TINY, seed=0, device=device)
            im = torch.from_numpy(images).to(device)
            tk = torch.from_numpy(tokens).to(device)
            r = {}
            with torch.no_grad(), (_CocaCalls(
                    counters, cfg, "tiny encodes and generation",
                    dict(image=4, text=2, decode=1, cache=2, step=22))
                    if device == "cuda" else contextlib.nullcontext()):
                r["image"] = model.encode_image(im)
                r["text"] = model.encode_text(tk)
                out = model(im, tk)
                r["logits"] = out["logits"]
                r["loss"] = torch.stack(coca_loss(
                    out["image_features"], out["text_features"],
                    out["logits"], out["labels"], out["logit_scale"]))
                r["greedy"] = coca.generate(model, im, seq_len=12)
                r["beam"] = coca.generate_beamsearch(model, im, seq_len=12)
            state = ContrastiveState(model, make_optimizer(
                model.named_parameters(), lambda step: lr))
            with (_CocaCalls(counters, cfg, "tiny train step",
                             dict(image=1, text=1, decode=1))
                  if device == "cuda" else contextlib.nullcontext()):
                r["step_loss"] = make_coca_train_step()(state, im, tk)[1][
                    "loss"]
            r["params"] = model.state_dict()
            runs[device] = torch.utils._pytree.tree_map(
                lambda t: t.detach().cpu() if isinstance(t, torch.Tensor)
                else t, r)
    cpu, card = runs["cpu"], runs["cuda"]
    errs = {}
    for k in ("image", "text", "logits", "loss", "step_loss"):
        a, b = torch.utils._pytree.tree_leaves(cpu[k]), \
            torch.utils._pytree.tree_leaves(card[k])
        errs[k] = max(float((x - y).abs().max()) for x, y in zip(a, b))
    for k in ("greedy", "beam"):
        require(torch.equal(cpu[k], card[k]),
                f"(q) tiny {k} ids: card {card[k]}, CPU {cpu[k]}")
    key_bias, worst = 0.0, 0.0
    for k, v in cpu["params"].items():
        d = (card["params"][k] - v).abs()
        if k.endswith("qkv_b"):
            n = d.shape[0] // 3
            key_bias = max(key_bias, float(d[n:2 * n].max()))
            d[n:2 * n] = 0
        worst = max(worst, float(d.max()))
    errs["params"] = worst
    require(all(v <= 1e-5 for v in errs.values()) and key_bias <= 2 * lr,
            f"(q) tiny CoCa card vs CPU: {errs}, key biases {key_bias}")
    say(f"(q) tiny CoCa, fp32, TF32 off, card vs CPU: max abs {errs}, key "
        f"biases after the step {key_bias:.3g} (<= 2 lr); greedy and beam ids "
        f"equal ({card['beam'][:, :8].tolist()} ...)")
    return {"max_abs": errs, "key_bias": key_bias}


def phase_coca(workdir: str):
    """(q) at full width: `benchmark.cli eval --task captioning` with
    coca_ViT-L-14 (1024-wide vision, 768-wide text and decoder, cut in
    depth by `COCA_DEPTH_CUTS` where `main` runs it; random weights, seed
    0; fp32, TF32 off, batch 64) on a Karpathy JSON of 64
    seeded 224 x 224 `.npy` images with 5 captions each, with the default
    beam search (K 6, G 3, seq_len 30) and with `--generation-type top_k`;
    `contrastive_driver.main --model coca_ViT-B-32` (bf16 on fp32 masters,
    batch 256, (n)'s flags and tar shards) for 2 steps and a resume for
    1; `utils.profiler.main --model coca_ViT-L-14` on the card against the
    CPU count.  Each part holds its launches to its calls.  Between them,
    one generation of each kind under `torch.profiler`: the device's busy
    time and idle share, and its time by kernel family."""
    import torch
    from leaf_tpu_torch.benchmark import cli
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models import coca
    from leaf_tpu_torch.profile_serve import profile_cell
    from leaf_tpu_torch.train import contrastive_driver as cd
    from leaf_tpu_torch.utils import profiler

    root = os.path.join(workdir, "q")
    os.makedirs(root)
    rng = np.random.default_rng(73)
    ann = _write_coco_set(os.path.join(root, "coco"), rng, COCA_IMAGES, 224)
    counters = {"coca_captioning": _Counters(), "coca_train": _Counters()}
    out = {}

    # ---- captioning at coca_ViT-L-14 ----------------------------------------
    cfg = coca.get_coca_config(COCA_CAPTION_MODEL)
    # seq_len 30 (the default) counts the SOT slot
    steps = min(30, cfg.multimodal.context_length) - 1
    for gen in ("beam_search", "top_k"):
        seconds = {}
        with _CocaCalls(counters["coca_captioning"], cfg,
                        f"captioning {gen}",
                        dict(image=1, cache=1, step=steps)) as calls:
            res = cli.main(["eval", "--task", "captioning", "--model",
                            COCA_CAPTION_MODEL, "--dataset",
                            "mscoco_captions", "--dataset-root",
                            os.path.dirname(ann), "--annotation-file", ann,
                            "--generation-type", gen, "--device", "cuda",
                            "--output", os.path.join(root, f"{gen}.json")],
                           seconds=seconds)[0]
        m = res["metrics"]
        require(m["num_samples"] == COCA_IMAGES
                and np.isfinite(m["bleu4"]) and 0.0 <= m["bleu4"] <= 1.0
                and np.isfinite(m["cider_d"]) and m["cider_d"] >= 0.0,
                f"(q) captioning {gen}: {m}")
        after_build = calls.seconds - seconds["build"]
        ms_pos = (seconds["generate"] - calls.image_s) / steps * 1e3
        out[f"captioning {gen}"] = {
            "seconds": calls.seconds, "part_seconds": seconds,
            "captions_per_s": COCA_IMAGES / after_build,
            "image_encode_s": calls.image_s, "ms_per_position": ms_pos,
            "peak_gib": calls.peak_gib, "launches": calls.launches,
            "metrics": m}
        say(f"(q) captioning {gen}, {COCA_CAPTION_MODEL} fp32, {COCA_IMAGES} "
            f"images: "
            f"{calls.seconds:.2f} s (build {seconds['build']:.2f}, data "
            f"{seconds['data']:.2f}, generate {seconds['generate']:.2f} of "
            f"which the image encode {calls.image_s:.3f}); "
            f"{COCA_IMAGES / after_build:.1f} captions/s after the build; "
            f"{ms_pos:.2f} ms a generated position ({steps} for the batch); "
            f"metrics {m}")

    # ---- where a captioning batch's time goes ---------------------------------
    model = coca.create_coca_model(COCA_CAPTION_MODEL, seed=0, device="cuda")
    size = cfg.vision.image_size
    images = torch.randn(COCA_IMAGES, size, size, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0))
    with fp32_products():
        for gen, fn in (("beam_search", coca.generate_beamsearch),
                        ("top_k", coca.generate)):
            # each batch ends in the ids' copy to the host, as the CLI's
            out[f"profile {gen}"] = profile_cell(
                f"(q) {gen}, {COCA_CAPTION_MODEL} fp32, {COCA_IMAGES} images "
                f"(the image encode and the {steps} positions)",
                lambda: fn(model, images).cpu(), batches=2, warm=1,
                profiled=1)
    del model, images

    # ---- training at coca_ViT-B-32 ------------------------------------------
    tcfg = coca.get_coca_config(COCA_TRAIN_MODEL)
    train = os.path.join(workdir, "clip_train")
    if not os.path.isdir(train):
        _write_pair_tars(train, rng, CLIP_SHARDS, CLIP_PER_SHARD)
    train = os.path.join(train, "{000..%03d}.tar" % (CLIP_SHARDS - 1))
    logs = os.path.join(root, "logs")
    want = _coca_launches(tcfg, image=1, text=1, decode=1)
    for tag, extra, n_steps in (
            ("train", ["--train-num-samples", str(COCA_STEPS * CLIP_BATCH),
                       "--epochs", "1"], COCA_STEPS),
            ("resumed", ["--train-num-samples", str(CLIP_BATCH), "--epochs",
                         "2", "--resume", "latest"], 1)):
        c = counters["coca_train"]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        c.zero()
        t0 = time.perf_counter()
        with _ContrastiveRun(c) as run:
            res = cd.main(COCA_FLAGS + ["--train-data", train, "--logs", logs,
                                        "--name", "coca"] + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = [float(v) for v in run.losses]
        times = res["times"]
        require(len(run.steps) == len(times) == len(losses) == n_steps
                and all(np.isfinite(v) and v > 0 for v in losses),
                f"(q) {tag}: {len(run.steps)} steps, losses {losses}")
        launched = {k: op.launches for k, op in c.ops.items()}
        require(all(s == want for s in run.steps)
                and launched == {k: v * n_steps for k, v in want.items()},
                f"(q) {tag}: launches a step {run.steps}, {want} expected; "
                f"{launched} in all")
        for k in c.total:
            c.total[k] += launched[k]
        steps_out = [dict(t, loop_pairs_per_s=sps,
                          device_pairs_per_s=CLIP_BATCH / t["device_s"],
                          peak_gib=gib)
                     for t, sps, gib in zip(times, run.sps, run.peaks)]
        for i, s in enumerate(steps_out):
            say(f"(q) {COCA_TRAIN_MODEL} {tag} step {i + 1}: "
                f"{s['device_s']:.4f} "
                f"s on the device ({s['device_pairs_per_s']:.1f} pairs/s), "
                f"the loader kept the host waiting {s['wait_s']:.4f} s, the "
                f"loop's {s['loop_pairs_per_s']:.1f} pairs/s; peak "
                f"{s['peak_gib']:.2f} GiB; launches {want}")
        if tag == "resumed":
            rows = [str(r["epoch"]) for r in res["results"]]
            require(res["state"].step == COCA_STEPS + 1
                    and rows == ["0", "1", "2"],
                    f"(q) resume: step {res['state'].step}, rows {rows}")
        say(f"(q) {COCA_TRAIN_MODEL} {tag}: {n_steps} steps in {seconds:.1f} s "
            f"(build and checkpoint included), losses "
            f"{[round(v, 4) for v in losses]}, step {res['state'].step}")
        out[f"coca_train {tag}"] = {"seconds": seconds, "steps": steps_out,
                                    "losses": losses,
                                    "launches_a_step": want}
        del res, run
    shutil.rmtree(logs, ignore_errors=True)

    # ---- the profiler -------------------------------------------------------
    t0 = time.perf_counter()
    card_row = profiler.main(["--model", COCA_CAPTION_MODEL, "--device",
                              DEVICE])[0]
    cpu_row = profiler.profile_model(COCA_CAPTION_MODEL, device="cpu")
    for k in ("gflops_image", "gflops_text"):
        rel = abs(card_row[k] - cpu_row[k]) / cpu_row[k]
        require(rel <= 0.01, f"(q) profiler {k}: card {card_row[k]} vs CPU "
                f"{cpu_row[k]}")
    require(card_row["mparams"] == cpu_row["mparams"], "(q) profiler mparams")
    out["profiler"] = {"card": card_row, "cpu": cpu_row,
                       "seconds": time.perf_counter() - t0}
    say(f"(q) profiler {COCA_CAPTION_MODEL} on the card {card_row}; on the "
        f"CPU {cpu_row}")
    shutil.rmtree(root, ignore_errors=True)
    return {path: c.total for path, c in counters.items()}, out


# ---------------------------------------------------------------------------
# (r) the ViT-family zoo: SigLIP, MobileCLIP
# ---------------------------------------------------------------------------

ZOO_TINY = ("siglip-tiny-test", "mci-vit-tiny-test", "fastvit-tiny-test")
ZOO_B, ZOO_S2, ZOO_SIGLIP = ("MobileCLIP-B", "MobileCLIP-S2",
                             "ViT-SO400M-14-SigLIP-384")
ZOO_PARITY_ROWS = 8     # the bf16 rows held against fp32 on the card


def _zoo_launches(cfg, image=0, text=0):
    """Launches of each packed kernel and of the LayerNorm op for `image`
    image and `text` text encodes of `cfg`: a fused block per transformer
    layer.  The LayerNorm op: `ln_2` per block and `ln_final` a text
    encode; a ViT image encode `ln_2` per block, `ln_pre`, `ln_post` and
    the MAP head's LN where the tower has them; an MCi-ViT image encode
    `ln_2` per block and `ln_post`; FastViT launches none of them."""
    from leaf_tpu_torch.models.mci import FastVitSpec
    if isinstance(cfg.trunk, FastVitSpec):
        blocks = ln = 0
    elif cfg.trunk is not None:
        blocks, ln = cfg.trunk.layers, cfg.trunk.layers + 1
    else:
        v = cfg.vision
        blocks = v.layers
        ln = v.layers + int(v.ln_pre) + 1 + int(v.attn_pool)
    packed = blocks * image + cfg.text.layers * text
    return {"packed_attention": packed, "fused_attention_block": packed,
            "layer_norm": ln * image + (cfg.text.layers + 1) * text}


class _ZooPart:
    """One part of (r) or (s) on the card: the kernels' counters zeroed and
    the memory's peak reset on entry; on exit the counters held to
    `launches` (`_zoo_launches`, `_convnet_launches`) of the part's encodes
    and added to the totals, its seconds and peak memory kept."""

    def __init__(self, counters, cfg, tag: str, image: int = 0,
                 text: int = 0, launches=None, phase: str = "r"):
        self.counters, self.cfg, self.tag = counters, cfg, tag
        self.image, self.text = image, text
        self.expected = launches or _zoo_launches
        self.phase = phase

    def __enter__(self):
        import torch
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
        if exc_type is not None:
            return False
        self.peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        want = self.expected(self.cfg, self.image, self.text)
        self.launches = {n: op.launches for n, op in self.counters.ops.items()}
        say(f"({self.phase}) {self.tag}: {self.seconds:.2f} s, peak device "
            f"memory {self.peak_gib:.2f} GiB; {self.image} image and "
            f"{self.text} text encodes; launches {self.launches} = {want}")
        require(self.launches == want,
                f"({self.phase}) {self.tag}: launches {self.launches}, {want} "
                "expected")
        for name in want:
            self.counters.total[name] += want[name]
        return False


def _held_cosine(tag: str, low: np.ndarray, full: np.ndarray,
                 minimum: float = 0.99) -> float:
    """bf16 features against fp32 ones of the same rows: cosine >=
    `minimum` per row."""
    require(low.shape == full.shape and np.isfinite(low).all(),
            f"{tag}: {low.shape} against {full.shape}")
    low = low.astype(np.float32)
    cos = float((np.sum(low * full, -1) / (np.linalg.norm(low, axis=-1)
                                          * np.linalg.norm(full, axis=-1))
                 ).min())
    require(cos >= minimum,
            f"{tag}: bf16 vs fp32 min cosine {cos} < {minimum}")
    return cos


def _write_arrays(root: str, rng, n: int, size: int) -> str:
    """`n` seeded HWC uint8 `.npy` images of `size` x `size` in `root`."""
    os.makedirs(root)
    for i in range(n):
        np.save(os.path.join(root, f"{i:04d}.npy"),
                rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    return root


def _preprocessed(root: str, cfg, n: int) -> np.ndarray:
    """The first `n` images of `root` through the model's eval transform,
    as serve reads them."""
    from leaf_tpu_torch.models.preprocess import image_transform
    pre = image_transform(cfg.vision.image_size, mean=cfg.image_mean,
                          std=cfg.image_std)
    return np.stack([pre(np.load(os.path.join(root, f"{i:04d}.npy")))
                     for i in range(n)])


def _features32(model, tokens=None, images=None):
    """fp32 features on the card, TF32 off, normalised, as host arrays."""
    import torch
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    out = []
    with fp32_products(), torch.inference_mode():
        if tokens is not None:
            out.append(model.encode_text(tokens, normalize=True))
        if images is not None:
            out.append(model.encode_image(images, normalize=True))
    return [t.float().cpu().numpy() for t in out]


def phase_zoo_parity(workdir: str):
    """(r) tiny: siglip-tiny-test, mci-vit-tiny-test and fastvit-tiny-test
    in fp32, TF32 off, the card (kernels) against the CPU (plain versions)
    from the same seeded weights: image and text features within 1e-4; the
    card's launches held to its encodes."""
    import torch
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model
    counters, errs = _Counters(), {}
    for name in ZOO_TINY:
        cfg = get_model_config(name)
        rng = np.random.default_rng(81)
        size = cfg.vision.image_size
        images = rng.standard_normal((4, size, size, 3)).astype(np.float32)
        tokens = rng.integers(1, cfg.text.vocab_size,
                              (8, cfg.text.context_length)).astype(np.int32)
        feats = {}
        for device in ("cpu", "cuda"):
            model = create_model(name, precision="fp32", seed=0,
                                 device=device)
            with fp32_products(), torch.inference_mode(), (
                    _ZooPart(counters, cfg, f"tiny {name}", image=1, text=1)
                    if device == "cuda" else contextlib.nullcontext()):
                feats[device] = [model.encode_image(images).float().cpu(),
                                 model.encode_text(tokens).float().cpu()]
        errs[name] = max(float((a - b).abs().max())
                         for a, b in zip(feats["cpu"], feats["cuda"]))
        require(errs[name] <= 1e-4,
                f"(r) tiny {name}: card vs CPU max abs {errs[name]} > 1e-4")
    say(f"(r) tiny zoo, fp32, TF32 off, card vs CPU (image and text "
        f"features): max abs {errs}")
    return errs


def phase_zoo(workdir: str):
    """(r) at full width (and depth, but SO400M's: `ZOO_DEPTH_CUTS`), bf16,
    random weights from seed 0:
    MobileCLIP-B through `serve.main` (2,048 seeded captions at batch 256;
    256 seeded 224 x 224 `.npy` images at batch 128); MobileCLIP-S2's
    `encode_image` on 128 seeded 256 x 256 images (FastViT: no kernel
    launch) and `encode_text` on 256 captions (77 tokens, not causal); ViT-
    SO400M-14-SigLIP-384 through `serve.main --images` (128 seeded 384 x 384
    images at batch 64) and its `encode_text` on 256 seeded rows of 64 ids
    (SigLIP's tokenizer is not ported).  MobileCLIP-B's and SO400M's image
    batches are also encoded decoded already (128 and 64 images from the
    host, the copy included), to split serve's rate between the host's
    decode and the device.  Each part holds the kernels' launches to its
    encodes (serve: one warm-up batch and every batch), and its first rows'
    bf16 features to cosine >= 0.99 against the same model's fp32 ones on
    the card, TF32 off."""
    import torch
    from leaf_tpu_torch import serve
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    root = os.path.join(workdir, "r")
    os.makedirs(root)
    rng = np.random.default_rng(83)
    counters = {"zoo_mobileclip_b": _Counters(),
                "zoo_mobileclip_s2": _Counters(), "zoo_siglip": _Counters()}
    out = {}
    handler = _Rates()
    log = logging.getLogger("leaf_tpu_torch.serve")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    n = ZOO_PARITY_ROWS

    def serve_part(key, name, cfg, flag, path, count, batch, kind):
        batches = 1 + -(-count // batch)         # the warm-up batch and all
        with _ZooPart(counters[key], cfg, f"{name} serve {flag}",
                      **{kind: batches}) as part:
            res = serve.main(["--model", name, flag, path, "--output",
                              os.path.join(root, f"{key}_{kind}.npz"),
                              "--batch-size", str(batch), "--precision",
                              "bf16", "--device", "cuda"])
        feats = res[f"{kind}_features"]
        require(feats.shape == (count, cfg.embed_dim)
                and np.isfinite(feats).all(),
                f"(r) {name} {kind}: {feats.shape}")
        np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0,
                                   atol=1e-2)
        done, secs, rate = getattr(handler, kind)[-1]
        row = {"seconds": part.seconds, "encodes_per_s": rate,
               "window_s": secs, "peak_gib": part.peak_gib,
               "launches": part.launches}
        say(f"(r) {name} serve {kind}: {done} in {secs:.3f} s steady state, "
            f"{rate:.1f} encodes/s; part {part.seconds:.2f} s (build, data, "
            f"warm-up included), peak {part.peak_gib:.2f} GiB")
        return feats, row

    def timed_encodes(key, name, cfg, model, fn, x, kind):
        with torch.inference_mode(), _ZooPart(
                counters[key], cfg, f"{name} {kind} encodes",
                **{kind: 2}) as part:
            fn(x, normalize=True)                # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = fn(x, normalize=True).float().cpu().numpy()
            secs = time.perf_counter() - t0
        require(feats.shape == (len(x), cfg.embed_dim)
                and np.isfinite(feats).all(), f"(r) {name} {kind}")
        row = {"encodes_per_s": len(x) / secs, "batch_s": secs,
               "peak_gib": part.peak_gib, "launches": part.launches}
        say(f"(r) {name} {kind}: a batch of {len(x)} in {secs:.4f} s, "
            f"{len(x) / secs:.1f} encodes/s, peak {part.peak_gib:.2f} GiB")
        return feats, row

    try:
        # ---- MobileCLIP-B through serve.main -------------------------------
        cfg = get_model_config(ZOO_B)
        caps = _captions(rng, 2048, 3, 20)
        texts = os.path.join(root, "b_captions.txt")
        with open(texts, "w") as f:
            f.write("\n".join(caps) + "\n")
        images = _write_arrays(os.path.join(root, "b_images"), rng, 256,
                               cfg.vision.image_size)
        t_feats, out[f"{ZOO_B} text"] = serve_part(
            "zoo_mobileclip_b", ZOO_B, cfg, "--texts", texts, 2048, 256,
            "text")
        i_feats, out[f"{ZOO_B} image"] = serve_part(
            "zoo_mobileclip_b", ZOO_B, cfg, "--images", images, 256, 128,
            "image")
        # the same images already decoded, on the device alone
        model = create_model(ZOO_B, precision="bf16", seed=0, device="cuda")
        _, out[f"{ZOO_B} image, decoded"] = timed_encodes(
            "zoo_mobileclip_b", ZOO_B, cfg, model, model.encode_image,
            _preprocessed(images, cfg, 128), "image")
        del model
        ref = create_model(ZOO_B, precision="fp32", seed=0, device="cuda")
        full_t, full_i = _features32(
            ref, np.asarray(get_tokenizer(ZOO_B)(caps[:n])),
            _preprocessed(images, cfg, n))
        out[f"{ZOO_B} cosine"] = [
            _held_cosine(f"(r) {ZOO_B} text", t_feats[:n], full_t),
            _held_cosine(f"(r) {ZOO_B} image", i_feats[:n], full_i)]
        del ref

        # ---- MobileCLIP-S2: encode_image, encode_text ----------------------
        cfg = get_model_config(ZOO_S2)
        model = create_model(ZOO_S2, precision="bf16", seed=0, device="cuda")
        size = cfg.vision.image_size
        images = rng.standard_normal((128, size, size, 3)).astype(np.float32)
        tokens = np.asarray(get_tokenizer(ZOO_S2)(_captions(rng, 256, 3, 20)))
        i_feats, out[f"{ZOO_S2} image"] = timed_encodes(
            "zoo_mobileclip_s2", ZOO_S2, cfg, model, model.encode_image,
            images, "image")
        t_feats, out[f"{ZOO_S2} text"] = timed_encodes(
            "zoo_mobileclip_s2", ZOO_S2, cfg, model, model.encode_text,
            tokens, "text")
        del model
        ref = create_model(ZOO_S2, precision="fp32", seed=0, device="cuda")
        full_t, full_i = _features32(ref, tokens[:n], images[:n])
        out[f"{ZOO_S2} cosine"] = [
            _held_cosine(f"(r) {ZOO_S2} text", t_feats[:n], full_t),
            _held_cosine(f"(r) {ZOO_S2} image", i_feats[:n], full_i)]
        del ref, images

        # ---- ViT-SO400M-14-SigLIP-384 ---------------------------------------
        cfg = get_model_config(ZOO_SIGLIP)
        images = _write_arrays(os.path.join(root, "siglip_images"), rng, 128,
                               cfg.vision.image_size)
        i_feats, out[f"{ZOO_SIGLIP} image"] = serve_part(
            "zoo_siglip", ZOO_SIGLIP, cfg, "--images", images, 128, 64,
            "image")
        model = create_model(ZOO_SIGLIP, precision="bf16", seed=0,
                             device="cuda")
        ids = rng.integers(1, cfg.text.vocab_size,
                           (256, cfg.text.context_length)).astype(np.int32)
        t_feats, out[f"{ZOO_SIGLIP} text"] = timed_encodes(
            "zoo_siglip", ZOO_SIGLIP, cfg, model, model.encode_text, ids,
            "text")
        _, out[f"{ZOO_SIGLIP} image, decoded"] = timed_encodes(
            "zoo_siglip", ZOO_SIGLIP, cfg, model, model.encode_image,
            _preprocessed(images, cfg, 64), "image")
        del model
        ref = create_model(ZOO_SIGLIP, precision="fp32", seed=0,
                           device="cuda")
        full_t, full_i = _features32(ref, ids[:n],
                                     _preprocessed(images, cfg, n))
        out[f"{ZOO_SIGLIP} cosine"] = [
            _held_cosine(f"(r) {ZOO_SIGLIP} text", t_feats[:n], full_t),
            _held_cosine(f"(r) {ZOO_SIGLIP} image", i_feats[:n], full_i)]
        del ref
    finally:
        log.removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)
    say(f"(r) bf16 vs fp32 on the card, min cosine per part (text, image): "
        f"{ {k: v for k, v in out.items() if k.endswith('cosine')} }")
    return {path: c.total for path, c in counters.items()}, out


# ---------------------------------------------------------------------------
# (s) the convolutional and EVA towers: ModifiedResNet, ConvNeXt, EVA,
# ViTamin
# ---------------------------------------------------------------------------

CONV_TINY = ("rn-tiny-smoke", "convnext-tiny-test", "eva-tiny-test",
             "vitamin-tiny-test")
CONV_RN, CONV_CONVNEXT, CONV_EVA, CONV_VITAMIN = (
    "RN50", "convnext_base_w", "EVA02-L-14", "ViTamin-L")


def _convnet_launches(cfg, image=0, text=0):
    """Launches of each packed kernel and of the LayerNorm op for `image`
    image and `text` text encodes of a ModifiedResNet, ConvNeXt, EVA or
    ViTamin config, read from the JAX package's towers.  Text: a fused
    block per layer, `ln_2` per layer and `ln_final`.  No vision tower here
    packs: a ModifiedResNet launches nothing (BatchNorm, plain attention
    pool); a ConvNeXt the stem's LN, each downsample's and each block's, and
    `head_norm` (41 at convnext_base); an EVA `ln_1`, `ln_2` and, where it
    has them, `ln_inner` and `mlp.ln` per block, and `ln_post` (97 at
    EVA02-L); a ViTamin the stem's LN, each MBConv block's, the embedding's,
    `ln_1`, `ln_2` and the MLP's per ViT block, and `fc_norm` (102 at
    ViTamin-L)."""
    from leaf_tpu_torch.models.eva import EvaVisionSpec
    from leaf_tpu_torch.models.vitamin import ViTaminVisionSpec
    t = cfg.trunk
    if cfg.resnet is not None:
        ln = 0
    elif cfg.convnext is not None:
        depths = cfg.convnext.depths
        ln = 1 + (len(depths) - 1) + sum(depths) + 1
    elif isinstance(t, EvaVisionSpec):
        ln = t.layers * (2 + int(t.inner_attn_ln) + int(t.mlp_ln)) + 1
    elif isinstance(t, ViTaminVisionSpec):
        ln = 1 + sum(t.depths) + 1 + 3 * t.vit_depth + 1
    else:
        raise ValueError(f"{cfg.name}: not a tower of (s)")
    packed = cfg.text.layers * text
    return {"packed_attention": packed, "fused_attention_block": packed,
            "layer_norm": ln * image + (cfg.text.layers + 1) * text}


@contextlib.contextmanager
def _tiny_resnet():
    """`rn-tiny-smoke`, a ModifiedResNet CLIP at test size (one bottleneck
    a stage, width 8, 64 px), in the registry for the block."""
    from leaf_tpu_torch.models import config
    c = config
    config.register_model(c.CLIPConfig(
        name="rn-tiny-smoke", embed_dim=64,
        text=c.TextConfig(context_length=16, vocab_size=512, width=64,
                          heads=2, layers=2, output_dim=64),
        vision=c.VisionConfig(image_size=64, patch_size=32, width=128,
                              layers=4, output_dim=64),
        resnet=c.ResNetVisionSpec(layers=(1, 1, 1, 1), width=8,
                                  image_size=64, output_dim=64)))
    try:
        yield
    finally:
        del config._REGISTRY["rn-tiny-smoke"]


def phase_convnet_parity(workdir: str):
    """(s) tiny: the ModifiedResNet of `_tiny_resnet`, convnext-tiny-test,
    eva-tiny-test and vitamin-tiny-test in fp32, TF32 off, the card
    (kernels, cuDNN) against the CPU (plain versions) from the same seeded
    weights: image and text features within 1e-4; the card's launches
    held to its encodes."""
    import torch
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model
    counters, errs = _Counters(), {}
    with _tiny_resnet():
        for name in CONV_TINY:
            cfg = get_model_config(name)
            rng = np.random.default_rng(91)
            size = cfg.vision.image_size
            images = rng.standard_normal((4, size, size, 3)).astype(
                np.float32)
            tokens = rng.integers(1, cfg.text.vocab_size,
                                  (8, cfg.text.context_length)).astype(
                np.int32)
            feats = {}
            for device in ("cpu", "cuda"):
                model = create_model(name, precision="fp32", seed=0,
                                     device=device)
                with fp32_products(), torch.inference_mode(), (
                        _ZooPart(counters, cfg, f"tiny {name}", image=1,
                                 text=1, launches=_convnet_launches,
                                 phase="s")
                        if device == "cuda" else contextlib.nullcontext()):
                    feats[device] = [
                        model.encode_image(images).float().cpu(),
                        model.encode_text(tokens).float().cpu()]
            errs[name] = max(float((a - b).abs().max())
                             for a, b in zip(feats["cpu"], feats["cuda"]))
            require(errs[name] <= 1e-4,
                    f"(s) tiny {name}: card vs CPU max abs {errs[name]} > "
                    "1e-4")
    say(f"(s) tiny convnets, fp32, TF32 off, card vs CPU (image and text "
        f"features): max abs {errs}")
    return errs


def phase_convnets(workdir: str):
    """(s) at full width and depth, bf16, random weights from seed 0: RN50
    through `serve.main` (2,048 seeded captions at batch 256, 256 seeded
    224 x 224 `.npy` images at batch 128), then 128 of its images decoded
    already, at batch 128; convnext_base_w's `encode_image` on 128 seeded
    256 x 256 images at batch 64 and `encode_text` on 256 captions (D 640,
    10 heads); EVA02-L-14 through `serve.main --images` (128 seeded 224 x
    224 images at batch 64), then `encode_text` on 256 captions and a
    decoded image batch of 64; ViTamin-L's `encode_image` on 128 seeded
    224 x 224 images at batch 64 and `encode_text` on 256 captions.  Each
    part holds the kernels' launches to its encodes (`_convnet_launches`;
    serve: one warm-up batch and every batch; the batched encodes: one
    warm-up batch and every batch), and its first rows' bf16 features to
    cosine >= 0.99 against the same model's fp32 ones on the card, TF32
    off."""
    import torch
    from leaf_tpu_torch import serve
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    root = os.path.join(workdir, "s")
    os.makedirs(root)
    rng = np.random.default_rng(93)
    counters = {"conv_rn50": _Counters(), "conv_convnext": _Counters(),
                "conv_eva02": _Counters(), "conv_vitamin": _Counters()}
    out = {}
    handler = _Rates()
    log = logging.getLogger("leaf_tpu_torch.serve")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    n = ZOO_PARITY_ROWS

    def part(key, cfg, tag, **encodes):
        return _ZooPart(counters[key], cfg, tag, launches=_convnet_launches,
                        phase="s", **encodes)

    def serve_part(key, name, cfg, flag, path, count, batch, kind):
        batches = 1 + -(-count // batch)         # the warm-up batch and all
        with part(key, cfg, f"{name} serve {flag}", **{kind: batches}) as p:
            res = serve.main(["--model", name, flag, path, "--output",
                              os.path.join(root, f"{key}_{kind}.npz"),
                              "--batch-size", str(batch), "--precision",
                              "bf16", "--device", "cuda"])
        feats = res[f"{kind}_features"]
        require(feats.shape == (count, cfg.embed_dim)
                and np.isfinite(feats).all(),
                f"(s) {name} {kind}: {feats.shape}")
        np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0,
                                   atol=1e-2)
        done, secs, rate = getattr(handler, kind)[-1]
        row = {"seconds": p.seconds, "encodes_per_s": rate,
               "window_s": secs, "peak_gib": p.peak_gib,
               "launches": p.launches}
        say(f"(s) {name} serve {kind}: {done} in {secs:.3f} s steady state, "
            f"{rate:.1f} encodes/s; part {p.seconds:.2f} s (build, data, "
            f"warm-up included), peak {p.peak_gib:.2f} GiB")
        return feats, row

    def batched(key, name, cfg, fn, x, bs, kind):
        """A warm-up batch, then `x` in batches of `bs`, timed to the
        features' copy to the host."""
        with torch.inference_mode(), part(
                key, cfg, f"{name} {kind} encodes",
                **{kind: 1 + -(-len(x) // bs)}) as p:
            fn(x[:bs], normalize=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = np.concatenate([
                fn(x[i:i + bs], normalize=True).float().cpu().numpy()
                for i in range(0, len(x), bs)])
            secs = time.perf_counter() - t0
        require(feats.shape == (len(x), cfg.embed_dim)
                and np.isfinite(feats).all(), f"(s) {name} {kind}")
        row = {"encodes_per_s": len(x) / secs, "seconds": secs,
               "batch": bs, "peak_gib": p.peak_gib, "launches": p.launches}
        say(f"(s) {name} {kind}: {len(x)} at batch {bs} in {secs:.4f} s, "
            f"{len(x) / secs:.1f} encodes/s, peak {p.peak_gib:.2f} GiB")
        return feats, row

    def held(name, pairs):
        out[f"{name} cosine"] = [_held_cosine(f"(s) {name} {kind}", low, full)
                                 for kind, low, full in pairs]

    try:
        # ---- RN50 through serve.main ---------------------------------------
        cfg = get_model_config(CONV_RN)
        caps = _captions(rng, 2048, 3, 20)
        texts = os.path.join(root, "rn_captions.txt")
        with open(texts, "w") as f:
            f.write("\n".join(caps) + "\n")
        images = _write_arrays(os.path.join(root, "rn_images"), rng, 256,
                               cfg.vision.image_size)
        t_feats, out[f"{CONV_RN} text"] = serve_part(
            "conv_rn50", CONV_RN, cfg, "--texts", texts, 2048, 256, "text")
        i_feats, out[f"{CONV_RN} image"] = serve_part(
            "conv_rn50", CONV_RN, cfg, "--images", images, 256, 128, "image")
        # the same images already decoded, on the device alone
        model = create_model(CONV_RN, precision="bf16", seed=0, device="cuda")
        _, out[f"{CONV_RN} image, decoded"] = batched(
            "conv_rn50", CONV_RN, cfg, model.encode_image,
            _preprocessed(images, cfg, 128), 128, "image")
        del model
        ref = create_model(CONV_RN, precision="fp32", seed=0, device="cuda")
        full_t, full_i = _features32(
            ref, np.asarray(get_tokenizer(CONV_RN)(caps[:n])),
            _preprocessed(images, cfg, n))
        held(CONV_RN, [("text", t_feats[:n], full_t),
                       ("image", i_feats[:n], full_i)])
        del ref

        # ---- convnext_base_w: encode_image, encode_text ---------------------
        cfg = get_model_config(CONV_CONVNEXT)
        model = create_model(CONV_CONVNEXT, precision="bf16", seed=0,
                             device="cuda")
        size = cfg.vision.image_size
        images = rng.standard_normal((128, size, size, 3)).astype(np.float32)
        tokens = np.asarray(get_tokenizer(CONV_CONVNEXT)(
            _captions(rng, 256, 3, 20)))
        i_feats, out[f"{CONV_CONVNEXT} image"] = batched(
            "conv_convnext", CONV_CONVNEXT, cfg, model.encode_image, images,
            64, "image")
        t_feats, out[f"{CONV_CONVNEXT} text"] = batched(
            "conv_convnext", CONV_CONVNEXT, cfg, model.encode_text, tokens,
            256, "text")
        del model
        ref = create_model(CONV_CONVNEXT, precision="fp32", seed=0,
                           device="cuda")
        full_t, full_i = _features32(ref, tokens[:n], images[:n])
        held(CONV_CONVNEXT, [("text", t_feats[:n], full_t),
                             ("image", i_feats[:n], full_i)])
        del ref, images

        # ---- EVA02-L-14 -----------------------------------------------------
        cfg = get_model_config(CONV_EVA)
        images = _write_arrays(os.path.join(root, "eva_images"), rng, 128,
                               cfg.vision.image_size)
        i_feats, out[f"{CONV_EVA} image"] = serve_part(
            "conv_eva02", CONV_EVA, cfg, "--images", images, 128, 64, "image")
        model = create_model(CONV_EVA, precision="bf16", seed=0,
                             device="cuda")
        tokens = np.asarray(get_tokenizer(CONV_EVA)(
            _captions(rng, 256, 3, 20)))
        t_feats, out[f"{CONV_EVA} text"] = batched(
            "conv_eva02", CONV_EVA, cfg, model.encode_text, tokens, 256,
            "text")
        _, out[f"{CONV_EVA} image, decoded"] = batched(
            "conv_eva02", CONV_EVA, cfg, model.encode_image,
            _preprocessed(images, cfg, 64), 64, "image")
        del model
        ref = create_model(CONV_EVA, precision="fp32", seed=0, device="cuda")
        full_t, full_i = _features32(ref, tokens[:n],
                                     _preprocessed(images, cfg, n))
        held(CONV_EVA, [("text", t_feats[:n], full_t),
                        ("image", i_feats[:n], full_i)])
        del ref

        # ---- ViTamin-L: encode_image, encode_text --------------------------
        cfg = get_model_config(CONV_VITAMIN)
        model = create_model(CONV_VITAMIN, precision="bf16", seed=0,
                             device="cuda")
        size = cfg.vision.image_size
        images = rng.standard_normal((128, size, size, 3)).astype(np.float32)
        tokens = np.asarray(get_tokenizer(CONV_VITAMIN)(
            _captions(rng, 256, 3, 20)))
        i_feats, out[f"{CONV_VITAMIN} image"] = batched(
            "conv_vitamin", CONV_VITAMIN, cfg, model.encode_image, images, 64,
            "image")
        t_feats, out[f"{CONV_VITAMIN} text"] = batched(
            "conv_vitamin", CONV_VITAMIN, cfg, model.encode_text, tokens, 256,
            "text")
        del model
        ref = create_model(CONV_VITAMIN, precision="fp32", seed=0,
                           device="cuda")
        full_t, full_i = _features32(ref, tokens[:n], images[:n])
        held(CONV_VITAMIN, [("text", t_feats[:n], full_t),
                            ("image", i_feats[:n], full_i)])
        del ref, images
    finally:
        log.removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)
    say(f"(s) bf16 vs fp32 on the card, min cosine per part: "
        f"{ {k: v for k, v in out.items() if k.endswith('cosine')} }")
    return {path: c.total for path, c in counters.items()}, out


# ---------------------------------------------------------------------------
# (t) the rest of the served zoo: Swin, RelPos-ViT, the HF text towers
# (M2M100, RoBERTa/XLM-R, mT5) with CustomTextCLIP, and coca_roberta
# ---------------------------------------------------------------------------

HF_TINY = {   # test-size HF text towers, as config.json dicts
    "roberta": dict(model_type="roberta", vocab_size=120, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=128, max_position_embeddings=40,
                    type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1),
    "mt5": dict(model_type="mt5", vocab_size=120, d_model=64, d_kv=16,
                d_ff=96, num_layers=2, num_heads=4, pad_token_id=0),
    "m2m_100": dict(model_type="m2m_100", vocab_size=120, d_model=64,
                    encoder_layers=2, encoder_ffn_dim=128,
                    encoder_attention_heads=4, max_position_embeddings=64,
                    pad_token_id=1),
}
RT_TINY = ("swin-tiny-test", "relpos-tiny-test")
RT_SWIN, RT_RELPOS = "swin_base_patch4_window7_224", \
    "vit_relpos_medium_patch16_cls_224"
RT_HF = ("nllb-clip-base", "xlm-roberta-base-ViT-B-32", "mt5-base-ViT-B-32")
RT_COCA, RT_COCA_TINY = "coca_roberta-ViT-B-32", "coca-roberta-tiny-test"
RT_COSINE = 0.995       # bf16 against fp32, where bf16 applies


def _hf_ln(config) -> int:
    """LayerNorm-op launches of one HF encoder pass: RoBERTa's embedding LN
    and 2 a layer; M2M100's 2 a layer and the final one; T5's RMS norms are
    plain PyTorch."""
    mt = config.model_type
    if mt in ("roberta", "xlm-roberta"):
        return 1 + 2 * config.num_hidden_layers
    if mt == "m2m_100":
        return 2 * config.encoder_layers + 1
    return 0


def _rt_launches(cfg, image=0, text=0):
    """Launches of each packed kernel and of the LayerNorm op for `image`
    image and `text` text encodes of a (t) CLIP config.  Swin: the patch
    norm, ln_1 and ln_2 a block, a patch-merge norm a later stage and
    ln_post (53 at Swin-B); RelPos-ViT: ln_1 and ln_2 a block and ln_post
    (25); a ViT tower as `_zoo_launches`; no packed kernel in a trunk.  An
    HF text tower launches `_hf_ln` LayerNorms and no packed kernel; the
    native text tower a fused block and ln_2 a layer and ln_final."""
    from leaf_tpu_torch.models.hf_text import resolve_hf_config
    from leaf_tpu_torch.models.relpos_vit import RelPosViTSpec
    from leaf_tpu_torch.models.swin import SwinVisionSpec
    t = cfg.trunk
    if isinstance(t, SwinVisionSpec):
        blocks, ln = 0, 1 + 2 * sum(t.depths) + len(t.depths) - 1 + 1
    elif isinstance(t, RelPosViTSpec):
        blocks, ln = 0, 2 * t.layers + 1
    else:
        base = _zoo_launches(cfg, image=1)
        blocks, ln = base["packed_attention"], base["layer_norm"]
    if cfg.text.hf_model_name:
        tblocks, tln = 0, _hf_ln(resolve_hf_config(cfg.text.hf_model_name))
    else:
        tblocks, tln = cfg.text.layers, cfg.text.layers + 1
    packed = blocks * image + tblocks * text
    return {"packed_attention": packed, "fused_attention_block": packed,
            "layer_norm": ln * image + tln * text}


def _rt_ids(rng, n: int, vocab: int, pad: int, S: int = 77) -> np.ndarray:
    """`n` seeded rows of `S` ids in [3, vocab) with ragged padding: row i
    keeps 5 to S tokens, the rest is `pad`."""
    ids = rng.integers(3, vocab, (n, S)).astype(np.int64)
    for i, keep in enumerate(rng.integers(5, S + 1, n)):
        ids[i, keep:] = pad
    return ids


def _coca_hf_launches(cfg, tower_cfg, image=0, text=0, decode=0):
    """A CoCa with an HF text tower: `_coca_launches` for its vision tower
    and decoder, `_hf_ln` for each text encode."""
    want = _coca_launches(cfg, image=image, decode=decode)
    want["layer_norm"] += _hf_ln(tower_cfg) * text
    return want


def phase_rest_parity(workdir: str):
    """(t) tiny, fp32, TF32 off, the card (kernels) against the CPU (plain
    versions) from the same seeded weights, each within 1e-4 with its
    launches held: swin-tiny-test and relpos-tiny-test (image and text
    features); tiny RoBERTa, mT5 and M2M100 `HFTextTower`s (ragged ids,
    mean and cls poolers); coca-roberta-tiny-test's features and 8 greedy
    ids (identical), the generation re-encoding its whole prefix at each
    step."""
    import copy
    import torch
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models import coca
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.models.hf_text import HFTextTower
    counters, errs = _Counters(), {}

    def held(name, a, b):
        errs[name] = max(float((x - y).abs().max()) for x, y in zip(a, b))
        require(errs[name] <= 1e-4,
                f"(t) tiny {name}: card vs CPU max abs {errs[name]} > 1e-4")

    for name in RT_TINY:
        cfg = get_model_config(name)
        rng = np.random.default_rng(101)
        size = cfg.vision.image_size
        images = rng.standard_normal((4, size, size, 3)).astype(np.float32)
        tokens = rng.integers(1, cfg.text.vocab_size,
                              (8, cfg.text.context_length)).astype(np.int32)
        feats = {}
        for device in ("cpu", "cuda"):
            model = create_model(name, precision="fp32", seed=0,
                                 device=device)
            with fp32_products(), torch.inference_mode(), (
                    _ZooPart(counters, cfg, f"tiny {name}", image=1, text=1,
                             launches=_rt_launches, phase="t")
                    if device == "cuda" else contextlib.nullcontext()):
                feats[device] = [model.encode_image(images).float().cpu(),
                                 model.encode_text(tokens).float().cpu()]
        held(name, feats["cpu"], feats["cuda"])

    for kind, d in HF_TINY.items():
        for pooler in ("mean_pooler", "cls_pooler"):
            tower = HFTextTower(d, 32, pooler, seed=0).eval()
            ids = torch.from_numpy(_rt_ids(np.random.default_rng(102), 6,
                                           d["vocab_size"], d["pad_token_id"],
                                           S=24))
            card = copy.deepcopy(tower).cuda()
            with fp32_products(), torch.inference_mode():
                want = tower.call_with_tokens(ids)
                with _ZooPart(counters, None, f"tiny {kind} {pooler}",
                              text=1, phase="t",
                              launches=lambda _c, image, text, c=tower.config:
                              {"packed_attention": 0,
                               "fused_attention_block": 0,
                               "layer_norm": _hf_ln(c) * text}):
                    got = card.call_with_tokens(ids.cuda())
            held(f"{kind} {pooler}", want, [t.cpu() for t in got])

    cfg = coca.get_coca_config(RT_COCA_TINY)
    rng = np.random.default_rng(103)
    images = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(
        np.float32))
    tokens = torch.from_numpy(_rt_ids(rng, 4, 100, 1, S=16))
    special = dict(sot_token_id=0, eos_token_id=2, pad_id=1)
    out = {}
    for device in ("cpu", "cuda"):
        model = coca.create_coca_model(RT_COCA_TINY, seed=0, device=device)
        tower_cfg = model.text.config
        steps = 7          # seq_len 8 counts the SOT slot
        with fp32_products(), torch.inference_mode(), (
                _ZooPart(counters, cfg, f"tiny {RT_COCA_TINY}", image=2,
                         text=1 + steps, phase="t",
                         launches=lambda c, image, text:
                         _coca_hf_launches(c, tower_cfg, image=image,
                                           text=text, decode=steps))
                if device == "cuda" else contextlib.nullcontext()):
            x, t = images.to(device), tokens.to(device)
            out[device] = [model.encode_image(x)[0].cpu(),
                           model.encode_text(t)[0].cpu(),
                           coca.generate(model, x, seq_len=8, **special)
                           .cpu()]
    held(RT_COCA_TINY, out["cpu"][:2], out["cuda"][:2])
    require(torch.equal(out["cpu"][2], out["cuda"][2]),
            f"(t) tiny {RT_COCA_TINY}: greedy ids {out['cuda'][2].tolist()} "
            f"!= {out['cpu'][2].tolist()} on the CPU")
    say(f"(t) tiny, fp32, TF32 off, card vs CPU: max abs {errs}; "
        f"{RT_COCA_TINY} greedy ids equal: {out['cuda'][2].tolist()}")
    return errs


def phase_rest(workdir: str):
    """(t) at full width and depth, random weights from seed 0, each model
    built once: swin_base_patch4_window7_224 and
    vit_relpos_medium_patch16_cls_224 through `serve.main` in bf16 (1,024
    seeded captions at batch 256, 128 seeded 224 x 224 `.npy` images at
    batch 64); nllb-clip-base, xlm-roberta-base-ViT-B-32 and
    mt5-base-ViT-B-32 (the HF text tower fp32 as in the JAX package, the
    ViT-B-32 in bf16): `encode_text` on 512 seeded 77-token id rows with
    ragged padding at batch 256, `encode_image` on 128 seeded images at
    batch 64; coca_roberta-ViT-B-32's image and text features.  Each part
    holds the kernels' launches to its encodes (a warm-up batch and every
    batch), the bf16 rows to cosine >= 0.995 against fp32 on the card
    (TF32 off), the HF towers' card rows to the CPU's (cosine >= 0.9999),
    and coca_roberta-ViT-B-32's generation to fail as it does in OpenCLIP
    and the JAX package (its 768-wide decoder cannot take the pooler's
    512-wide image embeddings; greedy ids are held in the tiny part)."""
    import copy
    import torch
    from leaf_tpu_torch import serve
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models import coca
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import (_cast_weights, create_model,
                                               get_tokenizer)
    root = os.path.join(workdir, "t")
    os.makedirs(root)
    rng = np.random.default_rng(104)
    counters = {"rest_swin": _Counters(), "rest_relpos": _Counters(),
                "rest_hf_text": _Counters(), "rest_coca_roberta": _Counters()}
    out = {}
    handler = _Rates()
    log = logging.getLogger("leaf_tpu_torch.serve")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    n = ZOO_PARITY_ROWS

    def part(key, cfg, tag, **encodes):
        return _ZooPart(counters[key], cfg, tag, launches=_rt_launches,
                        phase="t", **encodes)

    def held(name, pairs):
        out[f"{name} cosine"] = [
            _held_cosine(f"(t) {name} {kind}", low, full, RT_COSINE)
            for kind, low, full in pairs]

    def batched(key, name, cfg, fn, x, bs, kind):
        with torch.inference_mode(), part(
                key, cfg, f"{name} {kind} encodes",
                **{kind: 1 + -(-len(x) // bs)}) as p:
            fn(x[:bs], normalize=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feats = np.concatenate([
                fn(x[i:i + bs], normalize=True).float().cpu().numpy()
                for i in range(0, len(x), bs)])
            secs = time.perf_counter() - t0
        require(feats.shape == (len(x), cfg.embed_dim)
                and np.isfinite(feats).all(), f"(t) {name} {kind}")
        row = {"encodes_per_s": len(x) / secs, "seconds": secs, "batch": bs,
               "peak_gib": p.peak_gib, "launches": p.launches}
        say(f"(t) {name} {kind}: {len(x)} at batch {bs} in {secs:.4f} s, "
            f"{len(x) / secs:.1f} encodes/s, peak {p.peak_gib:.2f} GiB")
        return feats, row

    try:
        # ---- Swin-B and RelPos-ViT through serve.main ---------------------
        caps = _captions(rng, 1024, 3, 20)
        texts = os.path.join(root, "captions.txt")
        with open(texts, "w") as f:
            f.write("\n".join(caps) + "\n")
        for key, name in (("rest_swin", RT_SWIN), ("rest_relpos", RT_RELPOS)):
            cfg = get_model_config(name)
            images = _write_arrays(os.path.join(root, key), rng, 128,
                                   cfg.vision.image_size)
            feats = {}
            for flag, path, count, batch, kind in (
                    ("--texts", texts, 1024, 256, "text"),
                    ("--images", images, 128, 64, "image")):
                with part(key, cfg, f"{name} serve {flag}",
                          **{kind: 1 + -(-count // batch)}) as p:
                    res = serve.main(["--model", name, flag, path,
                                      "--output",
                                      os.path.join(root, f"{key}_{kind}.npz"),
                                      "--batch-size", str(batch),
                                      "--precision", "bf16",
                                      "--device", "cuda"])
                feats[kind] = res[f"{kind}_features"]
                require(feats[kind].shape == (count, cfg.embed_dim)
                        and np.isfinite(feats[kind]).all(),
                        f"(t) {name} {kind}: {feats[kind].shape}")
                done, secs, rate = getattr(handler, kind)[-1]
                out[f"{name} {kind}"] = {
                    "seconds": p.seconds, "encodes_per_s": rate,
                    "window_s": secs, "peak_gib": p.peak_gib,
                    "launches": p.launches}
                say(f"(t) {name} serve {kind}: {done} in {secs:.3f} s "
                    f"steady state, {rate:.1f} encodes/s; part "
                    f"{p.seconds:.2f} s (build, data, warm-up included), "
                    f"peak {p.peak_gib:.2f} GiB")
            ref = create_model(name, precision="fp32", seed=0, device="cuda")
            full_t, full_i = _features32(
                ref, np.asarray(get_tokenizer(name)(caps[:n])),
                _preprocessed(images, cfg, n))
            held(name, [("text", feats["text"][:n], full_t),
                         ("image", feats["image"][:n], full_i)])
            del ref

        # ---- the HF text towers beside ViT-B-32 ---------------------------
        for name in RT_HF:
            cfg = get_model_config(name)
            t0 = time.perf_counter()
            model = create_model(name, precision="fp32", seed=0,
                                 device="cuda")
            build_s = time.perf_counter() - t0
            tower = model.module.text
            c = tower.config
            ids = _rt_ids(rng, 512, c.vocab_size, c.pad_token_id or 0)
            size = cfg.vision.image_size
            images = rng.standard_normal((128, size, size, 3)).astype(
                np.float32)
            full_i, = _features32(model, images=images[:n])
            with fp32_products():
                t_feats, out[f"{name} text"] = batched(
                    "rest_hf_text", name, cfg, model.encode_text, ids, 256,
                    "text")
            require(t_feats.dtype == np.float32, f"(t) {name} text dtype")
            # the fp32 tower's rows against the same weights on the CPU
            with fp32_products(), torch.inference_mode():
                cpu = copy.deepcopy(tower).cpu()
                want = cpu(torch.from_numpy(ids[:4]), normalize=True).numpy()
                del cpu
            cos = float(np.sum(want * t_feats[:4], -1).min())
            require(cos >= 0.9999,
                    f"(t) {name} text: card vs CPU min cosine {cos}")
            out[f"{name} text card vs CPU cosine"] = cos
            _cast_weights(model.module, torch.bfloat16)   # the ViT to bf16
            require(all(p.dtype == torch.float32 for p in tower.parameters()),
                    f"(t) {name}: the HF tower left fp32")
            i_feats, out[f"{name} image"] = batched(
                "rest_hf_text", name, cfg, model.encode_image, images, 64,
                "image")
            held(name, [("image", i_feats[:n], full_i)])
            out[f"{name} build_s"] = build_s
            say(f"(t) {name}: built in {build_s:.1f} s; text card vs CPU "
                f"cosine {cos:.6f}")
            del model, tower

        # ---- coca_roberta-ViT-B-32 ----------------------------------------
        cfg = coca.get_coca_config(RT_COCA)
        model = coca.create_coca_model(RT_COCA, seed=0, device="cuda")
        size = cfg.vision.image_size
        images = torch.from_numpy(rng.standard_normal(
            (64, size, size, 3)).astype(np.float32)).cuda()
        ids = torch.from_numpy(_rt_ids(rng, 256, model.text.vocab_size,
                                       1)).cuda()
        feats = {}
        for dt in (torch.float32, torch.bfloat16):
            model.set_compute_dtype(dt)
            with fp32_products(), torch.inference_mode(), _ZooPart(
                    counters["rest_coca_roberta"], cfg,
                    f"{RT_COCA} features {dt}", image=1, text=1, phase="t",
                    launches=lambda c, image, text, tc=model.text.config:
                    _coca_hf_launches(c, tc, image=image, text=text)) as p:
                feats[dt] = [model.encode_image(images)[0].float().cpu()
                             .numpy(),
                             model.encode_text(ids)[0].float().cpu().numpy()]
            out[f"{RT_COCA} features {str(dt)[6:]}"] = {
                "seconds": p.seconds, "peak_gib": p.peak_gib,
                "launches": p.launches}
        held(RT_COCA, [("image", feats[torch.bfloat16][0][:n],
                        feats[torch.float32][0][:n]),
                       ("text", feats[torch.bfloat16][1][:n],
                        feats[torch.float32][1][:n])])
        try:
            with torch.inference_mode():
                coca.generate(model, images[:1], seq_len=6)
            require(False, f"(t) {RT_COCA}: generation ran on shapes that "
                    "OpenCLIP and the JAX package refuse")
        except ValueError as e:
            # ln_1_kv (768) on the pooler's 512-wide image embeddings
            require("expected (512,)" in str(e),
                    f"(t) {RT_COCA}: generation failed otherwise: {e}")
            out[f"{RT_COCA} generation"] = f"refused: {e}"
            say(f"(t) {RT_COCA} generation refused as upstream: {e}")
        del model
    finally:
        log.removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)
    say(f"(t) bf16 vs fp32 on the card, min cosine per part: "
        f"{ {k: v for k, v in out.items() if k.endswith('cosine')} }")
    return {path: c.total for path, c in counters.items()}, out


# ---------------------------------------------------------------------------
# (u) training the zoo
# ---------------------------------------------------------------------------

U_CONTRASTIVE_TINY = ("siglip-tiny-test", "mci-vit-tiny-test",
                      "fastvit-tiny-test", "convnext-tiny-test",
                      "eva-tiny-test", "vitamin-tiny-test", "swin-tiny-test",
                      "relpos-tiny-test", "clipa-tiny-smoke", "rn-tiny-smoke")
U_LEAF_TINY = ("siglip-text-smoke", "clipa-tiny-smoke", "d640-text-smoke")
U_FARE_TINY = ("siglip-tiny-test", "clipa-tiny-smoke")
U_LEAF, U_RN, U_EVA, U_SIGLIP = ("convnext_base_w", "RN50", "EVA02-L-14",
                                 "ViT-B-16-SigLIP")
U_LEAF_BATCH, U_LEAF_RHO, U_LEAF_STEPS, U_EVAL_IMAGES = 32, 20, 2, 16
U_BATCH, U_STEPS = 32, 2
U_CAPTIONS = ["a photo of a cat", "stocks rally on earnings",
              "the match ended in a draw", "hello world"]


@contextlib.contextmanager
def _u_tiny_configs():
    """The tiny configs of (u) that neither registry has, registered for
    the block: `rn-tiny-smoke` (`_tiny_resnet`); `clipa-tiny-smoke`,
    ViT-tiny-test CLIPA-shaped (no `ln_pre`, mean pool then `ln_post`,
    non-causal 'last'-pooled text); `siglip-text-smoke`, ViT-tiny-test with
    siglip-tiny-test's text tower (non-causal, 'last'-pooled, a projection
    bias) at the CLIP BPE's vocabulary and context; `d640-text-smoke`, with
    convnext_base_w's 640-wide text tower cut to two layers."""
    import dataclasses
    from leaf_tpu_torch.models import config
    base = config.get_model_config("ViT-tiny-test")
    siglip = config.get_model_config("siglip-tiny-test").text
    d640 = config.get_model_config("convnext_base_w").text
    extra = [
        dataclasses.replace(
            base, name="clipa-tiny-smoke",
            text=dataclasses.replace(base.text, no_causal_mask=True,
                                     pool_type="last"),
            vision=dataclasses.replace(base.vision, pool_type="avg",
                                       ln_pre=False,
                                       final_ln_after_pool=True)),
        dataclasses.replace(base, name="siglip-text-smoke",
                            text=dataclasses.replace(
                                siglip, vocab_size=49408,
                                context_length=77)),
        dataclasses.replace(base, name="d640-text-smoke",
                            embed_dim=d640.output_dim,
                            text=dataclasses.replace(d640, layers=2))]
    with _tiny_resnet():
        for cfg in extra:
            config.register_model(cfg)
        try:
            yield
        finally:
            for cfg in extra:
                del config._REGISTRY[cfg.name]


def _key_bias(name: str, n: int):
    """The slice of an attention's key bias in a parameter of `n` values,
    or None: its true gradient is zero, so Adam turns each device's
    rounding noise there into a step of up to lr (ROADMAP Queue 3)."""
    if name.endswith("qkv_b"):
        return slice(n // 3, 2 * n // 3)
    if name.endswith("kv_b"):
        return slice(0, n // 2)
    if name.endswith(".k_b"):
        return slice(0, n)
    return None


def _u_params_err(cpu: dict, card: dict, lr: float, steps: int = 1):
    """(max abs difference of the parameters, key biases aside; of the key
    biases), each key bias held to 2 lr a step."""
    worst = bias = 0.0
    for k, a in cpu.items():
        d = (card[k].float() - a.float()).abs().reshape(-1)
        kb = _key_bias(k, d.numel()) if d.numel() > 1 else None
        if kb is not None:
            bias = max(bias, float(d[kb].max()))
            d = d.clone()
            d[kb] = 0
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    require(bias <= 2 * steps * lr, f"(u) key bias differs by {bias}")
    return worst, bias


def _u_host(sd: dict) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in sd.items()}


def phase_zoo_train_parity(workdir: str):
    """(u) tiny, fp32, TF32 off, the card (kernels forward and backward)
    against the CPU (plain versions) from the same seeded
    weights, one step each at lr 1e-4: the contrastive step on every vision
    family (SigLIP's with its sigmoid loss and logit bias; a ModifiedResNet
    whose BatchNorm statistics must not move) and coca-roberta-tiny-test's
    CoCa step on seeded ids; the fused LEAF step on a SigLIP-style, a
    CLIPA-style and a 640-wide text tower (the same adversarial sentences);
    the in-training eval's PGD through every vision family (3 sign steps
    from one start: at most 1% of pixels apart by more than 1e-6, a sign
    flip on a near-zero gradient); one FARE step at siglip-tiny-test and
    the CLIPA-shaped config.  Losses and parameters within 1e-4, each key
    bias within 2 lr."""
    import copy
    import torch
    from leaf_tpu_torch.attacks.image import attack_image_classification
    from leaf_tpu_torch.evals.zero_shot import fp32_products
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import fare
    from leaf_tpu_torch.train.contrastive import (
        ContrastiveState, make_coca_train_step, make_contrastive_train_step)
    from leaf_tpu_torch.train.fused import FusedLeafStep
    from leaf_tpu_torch.train.optim import make_optimizer
    from leaf_tpu_torch.train.step import TrainState
    lr, out = 1e-4, {}

    def held(tag, runs, extra=""):
        (cl, cp), (gl, gp) = runs["cpu"], runs["cuda"]
        err, bias = _u_params_err(cp, gp, lr)
        loss_err = abs(gl - cl) / max(1.0, abs(cl))
        require(np.isfinite(gl) and loss_err <= 1e-4 and err <= 1e-4,
                f"(u) tiny {tag}: loss card {gl} CPU {cl}; parameters "
                f"differ by {err}")
        out[tag] = {"loss": gl, "loss_err": loss_err, "param_err": err,
                    "key_bias_err": bias}
        say(f"(u) tiny {tag}: loss {gl:.6g} (CPU {cl:.6g}), parameters "
            f"within {err:.3g}, key bias {bias:.3g}{extra}")

    with fp32_products(), _u_tiny_configs():
        for name in U_CONTRASTIVE_TINY:
            cfg = get_model_config(name)
            rng = np.random.default_rng(111)
            size = cfg.vision.image_size
            images = rng.standard_normal((4, size, size, 3)).astype(
                np.float32)
            tokens = rng.integers(1, cfg.text.vocab_size, (
                4, cfg.text.context_length)).astype(np.int32)
            runs = {}
            for device in ("cpu", "cuda"):
                module = create_model(name, precision="fp32", seed=0,
                                      device=device,
                                      master_weights=True).module.train()
                stats = _u_host(dict(module.named_buffers()))
                state = ContrastiveState(module, make_optimizer(
                    module.named_parameters(), lambda s: lr))
                _, m = make_contrastive_train_step(
                    siglip=cfg.init_logit_bias is not None)(
                    state, torch.from_numpy(images).to(device),
                    torch.from_numpy(tokens).to(device))
                after = _u_host(dict(module.named_buffers()))
                require(all(torch.equal(after[k], stats[k]) for k in stats),
                        f"(u) tiny {name}: a buffer moved")
                runs[device] = (float(m["loss"]), _u_host(module.state_dict()))
            bn = [k for k in stats if k.endswith((".mean", ".var"))]
            held(f"contrastive {name}", runs,
                 f"; {len(bn)} BatchNorm statistics unchanged" if bn else "")
        name = "coca-roberta-tiny-test"
        rng = np.random.default_rng(112)
        images = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
        tokens = rng.integers(3, 99, (3, 16)).astype(np.int32)
        runs = {}
        for device in ("cpu", "cuda"):
            module = create_model(name, precision="fp32", seed=0,
                                  device=device).module.train()
            state = ContrastiveState(module, make_optimizer(
                module.named_parameters(), lambda s: lr))
            _, m = make_coca_train_step()(
                state, torch.from_numpy(images).to(device),
                torch.from_numpy(tokens).to(device))
            runs[device] = (float(m["loss"]), _u_host(module.state_dict()))
        held(f"CoCa {name} (HF text tower)", runs)

        tok = get_tokenizer("ViT-tiny-test")
        for name in U_LEAF_TINY:
            runs, adv, grads = {}, {}, {}
            for device in ("cpu", "cuda"):
                model = create_model(name, precision="fp32", seed=0,
                                     device=device, master_weights=True)
                text = model.module.text
                frozen = copy.deepcopy(text).requires_grad_(False)
                state = TrainState.create(text, make_optimizer(
                    text.named_parameters(), lambda s: lr))
                grads[device] = g = {}
                update = state.optimizer.update

                def keep_grads(step, text=text, g=g, update=update):
                    g.update(_u_host({n: p.grad for n, p in
                                      text.named_parameters()}))
                    return update(step)
                state.optimizer.update = keep_grads
                fs = FusedLeafStep(model.cfg, tok, rho=5, device=device)
                state, info = fs(state, frozen, U_CAPTIONS,
                                 np.random.default_rng(7))
                adv[device] = fs.adv_sentences(U_CAPTIONS, info)
                runs[device] = (float(info["metrics"]["loss"]),
                                _u_host(text.state_dict()))
            require(adv["cpu"] == adv["cuda"],
                    f"(u) tiny LEAF {name}: sentences {adv}")
            # the step's gradients within 1e-4 of their scale; after Adam,
            # an element whose gradient is near zero may step up to lr
            # either way on each device (its g / (|g| + eps) of rounding
            # noise; a large loss, as the 640-wide tower's, has more such
            # elements), so the parameters are held to 2 lr
            scale = max(float(v.abs().max()) for v in grads["cpu"].values())
            grad_err = max(float((grads["cuda"][k] - v).abs().max())
                           for k, v in grads["cpu"].items()) / scale
            (cl, cp), (gl, gp) = runs["cpu"], runs["cuda"]
            err = max(float((gp[k] - v).abs().max()) for k, v in cp.items())
            loss_err = abs(gl - cl) / max(1.0, abs(cl))
            require(loss_err <= 1e-4 and grad_err <= 1e-4 and err <= 2 * lr,
                    f"(u) tiny LEAF {name}: loss card {gl} CPU {cl}, "
                    f"gradients {grad_err} of their scale, parameters "
                    f"{err}")
            out[f"LEAF {name}"] = {"loss": gl, "loss_err": loss_err,
                                   "grad_err": grad_err, "param_err": err}
            say(f"(u) tiny LEAF {name}: loss {gl:.6g} (CPU {cl:.6g}), "
                f"gradients within {grad_err:.3g} of their scale "
                f"{scale:.3g}, parameters after Adam within {err:.3g}; the "
                f"same {len(adv['cpu'])} adversarial sentences")

        for name in U_CONTRASTIVE_TINY:
            cfg = get_model_config(name)
            rng = np.random.default_rng(113)
            size = cfg.vision.image_size
            images = rng.uniform(0, 1, (3, size, size, 3)).astype(np.float32)
            clf = rng.standard_normal((cfg.embed_dim, 5)).astype(np.float32)
            clf /= np.linalg.norm(clf, axis=0, keepdims=True)
            start = (2 / 255 * (2 * rng.uniform(0, 1, images.shape) - 1)
                     ).astype(np.float32)
            adv = {}
            for device in ("cpu", "cuda"):
                module = create_model(name, precision="fp32", seed=0,
                                      device=device).module
                module.requires_grad_(False)
                adv[device] = attack_image_classification(
                    module.visual, cfg, torch.from_numpy(images).to(device),
                    torch.from_numpy(clf).to(device),
                    torch.tensor([0, 3, 4], device=device), n_steps=3,
                    delta=torch.from_numpy(start).to(device)).cpu().numpy()
            apart = float(np.mean(np.abs(adv["cuda"] - adv["cpu"]) > 1e-6))
            require(apart <= 0.01 and np.abs(adv["cuda"] - images).max()
                    <= 2 / 255 + 1e-6, f"(u) tiny PGD {name}: {apart} of "
                    "the pixels apart")
            out[f"PGD {name}"] = {"pixels_apart": apart}
        say(f"(u) tiny in-training eval PGD, card vs CPU, share of pixels "
            f"apart by more than 1e-6: "
            f"{ {k[4:]: v['pixels_apart'] for k, v in out.items() if k.startswith('PGD')} }")

        for name in U_FARE_TINY:
            cfg = get_model_config(name)
            rng = np.random.default_rng(114)
            images = rng.uniform(0.2, 0.8, (2, 64, 64, 3)).astype(np.float32)
            start = (8 / 255 * (2 * rng.uniform(0, 1, images.shape) - 1)
                     ).astype(np.float32)
            fcfg = fare.FareConfig(steps=1, warmup=1, lr=lr, eps=8 / 255,
                                   iterations_adv=2, stepsize_adv=4 / 255,
                                   clean_weight=0.5, log_freq=1)
            runs = {}
            for device in ("cpu", "cuda"):
                visual = create_model(name, precision="fp32", seed=0,
                                      device=device,
                                      master_weights=True).module.visual
                res = fare.train_fare(
                    visual, cfg, fcfg, iter([(images, None)]),
                    starts=iter([torch.from_numpy(start).to(device)]))
                runs[device] = (float(res["final_loss"]),
                                _u_host(visual.state_dict()))
            held(f"FARE {name}", runs)
    return out


def _u_contrastive_launches(cfg, steps: int):
    """A contrastive step's launches: one forward of each tower
    (`_convnet_launches` for a ModifiedResNet or EVA tower, `_zoo_launches`
    for a ViT); the backward's kernels count apart, under the phase's
    guard."""
    per = (_zoo_launches(cfg, 1, 1) if cfg.resnet is None
           and cfg.trunk is None else _convnet_launches(cfg, 1, 1))
    return {k: v * steps for k, v in per.items()}


def _u_fare_launches(cfg, steps: int, iterations: int, remat: bool):
    """A FARE step's launches at clean weight 0: the frozen tower's anchor
    encode, `iterations` PGD encodes and the update's encode, the last
    `iterations + 1` differentiated (their blocks twice under remat); the
    LayerNorm op's `ln_2` with every block and, once an encode, `ln_pre`,
    `ln_post` and the MAP head's where the tower has them."""
    v = cfg.vision
    diff = iterations + 1
    blocks = v.layers * (1 + (2 if remat else 1) * diff)
    outside = int(v.ln_pre) + 1 + int(v.attn_pool)
    return {"packed_attention": steps * blocks,
            "fused_attention_block": steps * blocks,
            "layer_norm": steps * (blocks + outside * (1 + diff))}


class _ReadAround:
    """Wraps `obj.name`: the kernels' counters are read just before and
    just after each call (not zeroed), the differences kept in `calls`."""

    def __init__(self, obj, name: str, counters):
        self.obj, self.name, self.counters = obj, name, counters
        self.inner = getattr(obj, name)
        self.calls = []

    def _read(self):
        return {k: op.launches for k, op in self.counters.ops.items()}

    def __call__(self, *args, **kw):
        import torch
        before = self._read()
        out = self.inner(*args, **kw)
        torch.cuda.synchronize()
        after = self._read()
        self.calls.append({k: after[k] - before[k] for k in after})
        return out

    def __enter__(self):
        setattr(self.obj, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.inner)


def phase_zoo_train(workdir: str):
    """(u) at full width and depth, bf16 on fp32 master weights, random
    weights from seed 0, two steps a cell, each model built once:
    `train.driver.main` at convnext_base_w (the LEAF trainer's fused step on
    the synthetic caption, batch 32, rho 20; its zero-shot eval before and
    after the epoch on 16 seeded 256 x 256 `.npy` images, PGD-10 through the
    ConvNeXt tower); the contrastive step at RN50 (its BatchNorm statistics
    bit for bit the same after), EVA02-L-14 (a trunk) and ViT-B-16-SigLIP
    (the sigmoid loss with its logit bias, seeded ids: its SentencePiece
    tokenizer is not ported), batch 32 each; then FARE on the SigLIP tower
    with remat, PGD-10, batch 32.  Each cell's launches are held exactly
    to the count its config gives; loss finite, peak memory and seconds a
    step printed."""
    import torch
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import driver, fare
    from leaf_tpu_torch.train.contrastive import (
        ContrastiveState, make_contrastive_train_step)
    from leaf_tpu_torch.train.optim import make_optimizer

    root = os.path.join(workdir, "u")
    os.makedirs(root)
    rng = np.random.default_rng(115)
    counters = {f"zoo_train_{k}": _Counters() for k in
                ("leaf_convnext", "contrastive_rn50", "contrastive_eva",
                 "contrastive_siglip", "fare_siglip")}
    out = {}

    def hold(path, got, want, tag):
        say(f"(u) {tag}: launches {got} = {want}")
        require(got == want, f"(u) {tag}: launches {got}, {want} expected")
        for k in want:
            counters[path].total[k] += want[k]

    # ---- LEAF at convnext_base_w through driver.main
    cfg = get_model_config(U_LEAF)
    folder = _write_image_folder(os.path.join(root, "imagenet"), rng,
                                 U_EVAL_IMAGES, 2, cfg.vision.image_size)
    flags = ["--model", U_LEAF, "--precision", "bf16", "--dataset-type",
             "synthetic", "--batch-size", str(U_LEAF_BATCH), "--rho",
             str(U_LEAF_RHO), "--k_adv", "1", "--lr", "1e-5", "--wd", "1e-4",
             "--warmup", "1", "--lr-scheduler", "const", "--epochs", "1",
             "--train-num-samples", str(U_LEAF_BATCH * U_LEAF_STEPS),
             "--imagenet-val", folder, "--n_val_imagenet",
             str(U_EVAL_IMAGES), "--zeroshot-frequency", "1",
             "--log-every-n-steps", "1", "--seed", "0", "--logs", root,
             "--name", "leaf", "--device", "cuda"]
    handler = _Steps()
    log = logging.getLogger("leaf_tpu_torch.train.loop")
    log.addHandler(handler)
    c = counters["zoo_train_leaf_convnext"]
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        c.zero()
        t0 = time.perf_counter()
        with _ReadAround(driver, "zero_shot_eval", c) as evals:
            res = driver.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = {k: op.launches for k, op in c.ops.items()}
    finally:
        log.removeHandler(handler)
    L = cfg.text.layers
    # per step 2 probe + 2 candidate scoring encodes and the train
    # forward's 2 half encodes; the one caption's anchors once
    encodes = 6 * U_LEAF_STEPS + 1
    steps_got = {k: total[k] - sum(e[k] for e in evals.calls) for k in total}
    hold("zoo_train_leaf_convnext", steps_got,
         {"packed_attention": L * encodes, "fused_attention_block": L * encodes,
          "layer_norm": (L + 1) * encodes},
         f"LEAF {U_LEAF}, {U_LEAF_STEPS} fused steps ({encodes} text encodes)")
    # an eval: 100 classifier encodes of 10 classes x 80 templates; per
    # image batch the clean encode, 10 PGD steps and the adversarial one
    image_enc = -(-U_EVAL_IMAGES // U_LEAF_BATCH) * (10 + 2)
    per_eval = _convnet_launches(cfg, image=image_enc, text=100)
    require(len(evals.calls) == 2, f"(u) {len(evals.calls)} evals")
    for i, got in enumerate(evals.calls):
        hold("zoo_train_leaf_convnext", got, per_eval,
             f"LEAF {U_LEAF}, eval {i} (100 classifier and {image_enc} "
             "ConvNeXt image encodes)")
    steps = list(handler.steps)
    losses = [a[8] for a in steps]
    require(len(steps) == U_LEAF_STEPS and all(
        np.isfinite(v) and v > 0 for v in losses), f"(u) LEAF losses {losses}")
    rows = _csv_rows(os.path.join(res["out_dir"], "results.csv"))
    adv = [float(r["imagenet-zeroshot-val-top1-adv"]) for r in rows]
    require(len(rows) == 2 and all(0 <= a <= 1 for a in adv),
            f"(u) LEAF results.csv {rows}")
    parts = res["eval_seconds"]
    out["leaf_convnext_base_w"] = {
        "wall_s": wall, "step_s": [a[5] for a in steps], "losses": losses,
        "eval_s": {e: sum(p.values()) for e, p in parts.items()},
        "pgd_s": [p.get("pgd") for p in parts.values()],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    say(f"(u) LEAF {U_LEAF}: driver.main {wall:.1f} s; steps "
        f"{[round(a[5], 3) for a in steps]} s, losses "
        f"{[round(v, 5) for v in losses]}; evals "
        f"{ {e: round(v, 2) for e, v in out['leaf_convnext_base_w']['eval_s'].items()} } s "
        f"(PGD {[round(p or 0, 2) for p in out['leaf_convnext_base_w']['pgd_s']]}); "
        f"top-1 adv {adv}; peak "
        f"{out['leaf_convnext_base_w']['peak_gib']:.1f} GiB")
    del res
    shutil.rmtree(os.path.join(root, "leaf"), ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the contrastive step at RN50, EVA02-L-14 and ViT-B-16-SigLIP
    siglip_module = None
    for name, path in ((U_RN, "zoo_train_contrastive_rn50"),
                       (U_EVA, "zoo_train_contrastive_eva"),
                       (U_SIGLIP, "zoo_train_contrastive_siglip")):
        cfg = get_model_config(name)
        t0 = time.perf_counter()
        model = create_model(name, precision="bf16", seed=0, device="cuda",
                             master_weights=True)
        build_s = time.perf_counter() - t0
        module = model.module.train()
        module.visual.compute_dtype = torch.bfloat16
        siglip = cfg.init_logit_bias is not None
        size = cfg.vision.image_size
        g = torch.Generator(device="cuda").manual_seed(0)
        images = torch.randn(U_BATCH, size, size, 3, generator=g,
                             device="cuda")
        if cfg.text.hf_tokenizer_name:
            tokens = torch.from_numpy(rng.integers(
                1, cfg.text.vocab_size, (U_BATCH, cfg.text.context_length)
            ).astype(np.int32)).cuda()
        else:
            tokens = torch.from_numpy(np.asarray(get_tokenizer(name)(
                _captions(rng, U_BATCH, 3, 30)))).cuda()
        stats = {k: v.clone() for k, v in module.named_buffers()}
        bias0 = (float(module.logit_bias.detach()) if siglip else None)
        state = ContrastiveState(module, make_optimizer(
            module.named_parameters(), lambda s: 5e-4, weight_decay=0.2))
        step = make_contrastive_train_step(siglip)
        c = counters[path]
        seconds, peaks, losses = [], [], []
        torch.cuda.synchronize()
        c.zero()
        for _ in range(U_STEPS):
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, m = step(state, images, tokens)
            end.record()
            end.synchronize()
            seconds.append(start.elapsed_time(end) / 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            losses.append(float(m["loss"]))
        hold(path, {k: op.launches for k, op in c.ops.items()},
             _u_contrastive_launches(cfg, U_STEPS),
             f"contrastive {name}, {U_STEPS} steps")
        require(all(np.isfinite(v) for v in losses),
                f"(u) {name} losses {losses}")
        same = all(torch.equal(v, stats[k])
                   for k, v in module.named_buffers())
        require(same, f"(u) {name}: a buffer changed")
        cell = {"build_s": build_s, "step_s": seconds, "losses": losses,
                "peak_gib": max(peaks)}
        extra = ""
        bn = [k for k in stats if k.endswith((".mean", ".var"))]
        if bn:
            extra = f"; {len(bn)} BatchNorm statistics bit for bit equal"
        if siglip:
            cell["logit_bias"] = float(module.logit_bias.detach())
            require(cell["logit_bias"] != bias0, "(u) logit bias unmoved")
            extra = (f"; sigmoid loss, logit bias {bias0} -> "
                     f"{cell['logit_bias']:.6g}")
        out[f"contrastive {name}"] = cell
        say(f"(u) contrastive {name}: build {build_s:.1f} s; steps "
            f"{[round(t, 4) for t in seconds]} s on the device "
            f"({U_BATCH / float(np.mean(seconds)):.1f} pairs/s), losses "
            f"{[round(v, 5) for v in losses]}, peak {max(peaks):.1f} GiB"
            f"{extra}")
        if siglip:
            siglip_module = module
        del model, module, state, images, tokens
        torch.cuda.empty_cache()

    # ---- FARE on the SigLIP tower, remat
    cfg = get_model_config(U_SIGLIP)
    visual = siglip_module.visual
    fcfg = fare.FareConfig(steps=U_STEPS, warmup=1, batch_size=U_BATCH,
                           lr=1e-5, wd=1e-4, eps=2 / 255, iterations_adv=10,
                           stepsize_adv=1 / 255, remat=True, log_freq=1)
    size = cfg.vision.image_size
    batch = rng.uniform(0, 1, (U_BATCH, size, size, 3)).astype(np.float32)
    c = counters["zoo_train_fare_siglip"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c.zero()
    res = fare.train_fare(visual, cfg, fcfg, iter([(batch, None)] * U_STEPS))
    torch.cuda.synchronize()
    hold("zoo_train_fare_siglip", {k: op.launches for k, op in c.ops.items()},
         _u_fare_launches(cfg, U_STEPS, 10, True),
         f"FARE {U_SIGLIP}, {U_STEPS} steps, remat, PGD-10")
    require(res["steps"] == U_STEPS and np.isfinite(res["final_loss"]),
            f"(u) FARE {res['steps']} steps, loss {res['final_loss']}")
    dev = [t["step_s"] for t in res["times"]]
    out[f"FARE {U_SIGLIP}"] = {
        "step_s": dev, "final_loss": res["final_loss"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    say(f"(u) FARE {U_SIGLIP}, remat: steps {dev} s on the device, loss "
        f"{res['final_loss']:.6g}, peak "
        f"{out[f'FARE {U_SIGLIP}']['peak_gib']:.1f} GiB")
    del res, visual, siglip_module
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return {path: c.total for path, c in counters.items()}, out


# ---------------------------------------------------------------------------
# (v) multiple ranks: two processes on the one card over gloo
# ---------------------------------------------------------------------------

V_TINY = "ViT-tiny-test"
V_LEAF, V_CLIP = "ViT-L-14-quickgelu", "ViT-B-32"
# a rank's batch: the global batches are 128 (LEAF, rho 50) and 256
V_LEAF_BATCH, V_LEAF_RHO, V_CLIP_BATCH, V_STEPS = 64, 50, 128, 2
V_LR = 1e-4
V_TINY_CAPTIONS = [f"a photo of object number {i} on a table"
                   for i in range(8)]
V_TINY_FRESH = [f"an unseen fresh caption number {i}" for i in range(4)]


def _v_params_err(ref: dict, got: dict, steps: int):
    """Max abs difference of two parameter sets, the attention's key bias
    aside and held to 2 lr a step (its true gradient is zero: Adam turns
    each device's rounding noise there into a step of up to lr)."""
    worst = 0.0
    for k, a in ref.items():
        d = (got[k].float().cpu() - a.float().cpu()).abs().reshape(-1)
        kb = _key_bias(k, d.numel()) if d.numel() > 1 else None
        if kb is not None:
            require(float(d[kb].max()) <= 2 * steps * V_LR,
                    f"(v) key bias {k} differs by {float(d[kb].max())}")
            d = d.clone()
            d[kb] = 0
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def _v_digest(module) -> str:
    """A hash of a module's parameters' bytes (equal bit for bit across
    ranks or not)."""
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


class _VCollectives:
    """Seconds spent in the collectives of `parallel.distributed` (the
    card synchronised before and after each), patched in for a block."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        import torch
        from leaf_tpu_torch.parallel import distributed as D
        from leaf_tpu_torch.train import fused
        self.saved = [(D, n, getattr(D, n)) for n in (
            "_all_reduce_sum_", "_gather_rows", "_reduce_scatter_rows",
            "_exchange", "global_max_int32")]
        self.saved.append((fused, "global_max_int32", fused.global_max_int32))

        def timed(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return call
        for mod, name, fn in self.saved:
            setattr(mod, name, timed(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _v_watch(opt, log: list) -> None:
    """Record, at each update of `opt` (`train.optim.Optimizer`), what
    AdamW's step depends on: the step count `update` was given, each
    group's learning rate, weight decay and eps, AdamW's path, a digest of
    the parameters before the step and their layout (for `_v_rank_diff`)."""
    import hashlib
    update, step = opt.update, opt.adamw.step

    def watched_update(n):
        log.append({"step": int(n)})
        return update(n)

    def watched_step(*a, **kw):
        groups = opt.adamw.param_groups
        h = hashlib.sha256()
        for q in opt.parameters():
            h.update(q.detach().float().cpu().numpy().tobytes())
        g0 = groups[0]
        log[-1].update(
            lr=[g["lr"] for g in groups],
            weight_decay=[g["weight_decay"] for g in groups],
            eps=[g["eps"] for g in groups],
            path=("fused" if g0.get("fused") else "foreach"
                  if g0.get("foreach") else "for-loop"),
            params_before=h.hexdigest()[:16],
            layout=[[q.is_contiguous(), q.storage_offset()]
                    for q in opt.parameters()])
        return step(*a, **kw)
    opt.update, opt.adamw.step = watched_update, watched_step


def _v_tiny(D, device):
    """One rank's tiny runs on `device`: three fused steps (anchors
    missed, every rank hits, rank 1 misses), an unfused step, InfoNCE
    global and `--local-loss`, the SigLIP ring, a FARE step.  Returns
    {part: {losses, params (host copies), ...}}."""
    import copy
    import torch
    from leaf_tpu_torch.attacks.engine import (CandidateScorer,
                                               bucket_tokens_coordinated)
    from leaf_tpu_torch.attacks.text import attack_text_leaf
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import contrastive as tcon
    from leaf_tpu_torch.train import fare as tfare
    from leaf_tpu_torch.train.fused import FusedLeafStep
    from leaf_tpu_torch.train.optim import make_optimizer
    from leaf_tpu_torch.train.schedules import cosine_lr
    from leaf_tpu_torch.train.step import (TrainState, make_anchor_encode,
                                           make_train_step)

    rank = D.rank()
    tok = get_tokenizer(V_TINY)
    model = create_model(V_TINY, precision="fp32", seed=0, device=device,
                         master_weights=True)
    cfg = model.cfg
    out = {}

    def leaf_state():
        text = copy.deepcopy(model.module.text).requires_grad_(True)
        opt = make_optimizer(text.named_parameters(),
                             cosine_lr(V_LR, 1, 100), weight_decay=1e-4)
        return TrainState.create(text, opt)

    state = leaf_state()
    updates = []
    _v_watch(state.optimizer, updates)
    frozen = copy.deepcopy(model.module.text).requires_grad_(False)
    fused = FusedLeafStep(cfg, tok, rho=4, device=device)
    widths, branches = [], []
    p1, p1c = fused.phase1, fused.phase1_cached

    def full(fr, tr, clean, probes):
        widths.append(int(probes.shape[-1]))
        branches.append("full")
        return p1(fr, tr, clean, probes)

    def cached(tr, probes, anch):
        widths.append(int(probes.shape[-1]))
        branches.append("cached")
        return p1c(tr, probes, anch)
    fused.phase1, fused.phase1_cached = full, cached
    local = V_TINY_CAPTIONS[4 * rank:4 * rank + 4]
    rng = np.random.default_rng(7 + rank)
    losses = []
    for texts in (local, local, local if rank == 0 else V_TINY_FRESH):
        state, info = fused(state, frozen, texts, rng)
        losses.append(float(info["metrics"]["loss"]))
    out["fused"] = {"losses": losses, "widths": widths,
                    "branches": branches, "digest": _v_digest(state.text),
                    "params": _u_host(state.text.state_dict()), "steps": 3,
                    "updates": updates}

    state = leaf_state()
    scorer = CandidateScorer(cfg, device)
    tokens = torch.from_numpy(bucket_tokens_coordinated(tok(local))).to(
        device)
    anchors = make_anchor_encode()(frozen, tokens)
    _, adv = attack_text_leaf(scorer, state.text, tok, local, anchors, n=4,
                              rng=np.random.default_rng(5 + rank))
    adv_tokens = torch.from_numpy(bucket_tokens_coordinated(tok(adv))).to(
        device)
    state, metrics = make_train_step()(state, adv_tokens, anchors)
    out["unfused"] = {"losses": [float(metrics["loss"])], "adv": adv,
                      "digest": _v_digest(state.text),
                      "params": _u_host(state.text.state_dict()), "steps": 1}

    data = np.random.default_rng(11)
    images = data.standard_normal((8, 64, 64, 3)).astype(np.float32)
    ids = tok(V_TINY_CAPTIONS)
    rows = D.local_batch_slice(8)
    for name, kw in (("infonce", {}), ("local", {"local_loss": True}),
                     ("siglip", {"siglip": True})):
        net = copy.deepcopy(model.module)
        opt = make_optimizer(net.named_parameters(), lambda s: V_LR,
                             weight_decay=0.2)
        cstate = tcon.ContrastiveState(net, opt)
        cstate, metrics = tcon.make_contrastive_train_step(**kw)(
            cstate, torch.from_numpy(images[rows]).to(device),
            torch.from_numpy(ids[rows]).to(device))
        out[name] = {"losses": [float(metrics["loss"])],
                     "digest": _v_digest(net),
                     "params": _u_host(net.state_dict()), "steps": 1}

    net = copy.deepcopy(model.module)
    fimages = data.uniform(0.2, 0.8, (4, 64, 64, 3)).astype(np.float32)
    start = (8 / 255 * (2 * data.uniform(size=fimages.shape) - 1)).astype(
        np.float32)
    frows = D.local_batch_slice(4)
    fcfg = tfare.FareConfig(steps=1, warmup=1, lr=V_LR, eps=8 / 255,
                            iterations_adv=2, stepsize_adv=4 / 255,
                            log_freq=1)
    seen = []
    tfare.train_fare(net.visual, cfg, fcfg, iter([(fimages[frows], None)]),
                     starts=iter([torch.from_numpy(start[frows]).to(
                         device)]),
                     on_step=lambda s, m: seen.append(m))
    out["fare"] = {"losses": [seen[0]["loss"]], "digest": _v_digest(net),
                   "params": _u_host(net.visual.state_dict()), "steps": 1}
    return out


def _v_full(D, device, counters):
    """One rank's full-width runs: the fused LEAF step at V_LEAF's text
    tower (12 x 768; bf16 on fp32 masters; a rank's 64 of the global 128
    bucket-16 captions, rho 50), then the contrastive step at V_CLIP (a
    rank's 128 of the global 256 pairs) with InfoNCE and with the SigLIP
    ring, V_STEPS steps each.  Per step: its seconds, the collectives'
    seconds, the kernels' launches."""
    import torch
    from leaf_tpu_torch.models.clip import TextTower
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.train import contrastive as tcon
    from leaf_tpu_torch.train.fused import FusedLeafStep
    from leaf_tpu_torch.train.optim import make_optimizer
    from leaf_tpu_torch.train.schedules import cosine_lr
    from leaf_tpu_torch.train.step import TrainState

    rank = D.rank()
    out = {}
    cfg = get_model_config(V_LEAF)
    tok = get_tokenizer(V_LEAF)
    text = TextTower(cfg.text, cfg.quick_gelu)
    text.init_weights(torch.Generator().manual_seed(0))
    text = text.to(device)
    text.compute_dtype = torch.bfloat16
    frozen = TextTower(cfg.text, cfg.quick_gelu).to(device)
    frozen.load_state_dict(text.state_dict())
    frozen.compute_dtype = torch.bfloat16
    frozen.requires_grad_(False)
    opt = make_optimizer(text.named_parameters(), cosine_lr(V_LR, 1, 100))
    state = TrainState.create(text, opt)
    fused = FusedLeafStep(cfg, tok, rho=V_LEAF_RHO, device=device)
    widths = []
    p1, p1c = fused.phase1, fused.phase1_cached

    def full(fr, tr, clean, probes):
        widths.append(int(probes.shape[-1]))
        return p1(fr, tr, clean, probes)

    def cached(tr, probes, anch):
        widths.append(int(probes.shape[-1]))
        return p1c(tr, probes, anch)
    fused.phase1, fused.phase1_cached = full, cached
    captions = _captions(np.random.default_rng(97), 2 * V_LEAF_BATCH, 3, 7)
    texts = captions[D.local_batch_slice(len(captions))]
    rng = np.random.default_rng(13 + rank)

    def run(tag, step_fn, steps, encodes):
        rows = []
        counters.zero()
        for i in range(steps):
            torch.cuda.synchronize()
            before = {k: op.launches for k, op in counters.ops.items()}
            with _VCollectives() as coll:
                t0 = time.perf_counter()
                loss = step_fn()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            got = {k: op.launches - before[k]
                   for k, op in counters.ops.items()}
            rows.append({"s": seconds, "collective_s": coll.seconds,
                         "collectives": coll.calls, "loss": loss,
                         "launches": got, "want": encodes(i)})
        out[tag] = {"steps": rows}

    def leaf_step():
        nonlocal state
        state, info = fused(state, frozen, texts, rng)
        return float(info["metrics"]["loss"])

    layers = cfg.text.layers
    # a step's text encodes: anchors (missed at the first), probes,
    # candidates, the train forward (its backward's kernels count apart)
    run("leaf", leaf_step, V_STEPS, lambda i: {
        "packed_attention": layers * (4 if i == 0 else 3),
        "fused_attention_block": layers * (4 if i == 0 else 3),
        "layer_norm": (layers + 1) * (4 if i == 0 else 3)})
    out["leaf"].update(widths=widths, digest=_v_digest(text))
    del state, text, frozen, fused, opt
    torch.cuda.empty_cache()

    model = create_model(V_CLIP, precision="bf16", seed=0, device=device,
                         master_weights=True)
    model.module.visual.compute_dtype = torch.bfloat16
    ccfg = model.cfg
    ctok = get_tokenizer(V_CLIP)
    g = torch.Generator(device=device).manual_seed(5)
    size = ccfg.vision.image_size
    images = torch.randn((2 * V_CLIP_BATCH, size, size, 3), generator=g,
                         device=device)
    ids = torch.from_numpy(ctok(_captions(np.random.default_rng(98),
                                          2 * V_CLIP_BATCH, 3, 12))).to(
        device)
    rows = D.local_batch_slice(2 * V_CLIP_BATCH)
    opt = make_optimizer(model.module.named_parameters(), lambda s: V_LR)
    cstate = tcon.ContrastiveState(model.module, opt)
    for tag, siglip in (("infonce", False), ("siglip", True)):
        step = tcon.make_contrastive_train_step(siglip)

        def clip_step():
            nonlocal cstate
            cstate, metrics = step(cstate, images[rows], ids[rows])
            return float(metrics["loss"])
        run(tag, clip_step, V_STEPS,
            lambda i: _clip_launches(ccfg, 1))
        out[tag]["digest"] = _v_digest(model.module)
    return out


def _v_rank_diff(D, digests, card: dict, cpu: dict, updates=(None, None)):
    """Where the ranks' parameters differ, for the failure's message:
    {device: [{name, elements that differ, max abs difference, the first
    indices}], device + " updates": the first update whose record
    (`_v_watch`) differs across ranks, both ranks' records} (both ranks
    call it; None where every digest agrees)."""
    report = {}
    for i, device in enumerate(("card", "cpu")):
        if digests[0][i] == digests[1][i]:
            continue
        logs = D.all_gather_object(updates[i])
        if logs[0] is not None:
            report[device + " updates"] = next(
                ({"update": j, "ranks": [a, b]} for j, (a, b)
                 in enumerate(zip(*logs)) if a != b),
                {"update": None, "equal records": len(logs[0])})
        params = (card, cpu)[i]
        both = D.all_gather_object({k: v.numpy() for k, v in params.items()})
        rows = []
        for k, a in both[0].items():
            b = both[1][k]
            bad = np.flatnonzero(a.reshape(-1).view(np.int32)
                                 != b.reshape(-1).view(np.int32))
            if bad.size:
                rows.append({"name": k, "elements": int(a.size),
                             "differ": int(bad.size),
                             "max_abs": float(np.abs(a - b).max()),
                             "first": bad[:8].tolist()})
        report[device] = rows
    return report or None


def _v_worker(spec_path: str) -> int:
    """One rank of (v), spawned by `phase_multirank` (`python chip_smoke.py
    --v-rank <spec>` under the launcher's variables)."""
    import torch
    from leaf_tpu_torch.parallel import distributed as D
    with open(spec_path) as f:
        spec = json.load(f)
    info = D.init_distributed_device("cuda", backend=spec["backend"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": info["rank"], "world": info["world_size"],
           "device": str(info["device"]), "backend": spec["backend"]}
    t0 = time.perf_counter()
    if spec["tiny"]:
        card = _v_tiny(D, info["device"])
        cpu = _v_tiny(D, torch.device("cpu"))
        tiny = {}
        for part, c in card.items():
            p = cpu[part]
            scale = max(abs(v) for v in p["losses"])
            tiny[part] = {
                "loss_err": max(abs(a - b) for a, b in
                                zip(c["losses"], p["losses"])) / scale,
                "losses": c["losses"],
                "params_err": _v_params_err(p["params"], c["params"],
                                            c["steps"]),
                "same_decisions": all(c.get(k) == p.get(k) for k in
                                      ("widths", "branches", "adv")),
                "widths": c.get("widths"), "branches": c.get("branches"),
                "digests": D.all_gather_object([c["digest"],
                                                p["digest"]])}
            tiny[part]["rank_diff"] = _v_rank_diff(
                D, tiny[part]["digests"], c["params"], p["params"],
                (c.get("updates"), p.get("updates")))
        out["tiny"] = tiny
        out["tiny_s"] = time.perf_counter() - t0
    # the full-width part waits for the card to be this phase's alone
    gate = spec.get("gate")
    while gate and not os.path.exists(gate):
        time.sleep(0.1)
    torch.backends.cuda.matmul.allow_tf32 = True
    t0 = time.perf_counter()
    out["full"] = _v_full(D, info["device"], _Counters())
    out["full_s"] = time.perf_counter() - t0
    out["backward"] = _backward_counts()
    with open(spec["out"] % info["rank"], "w") as f:
        json.dump(out, f, default=float)
    D.barrier()
    return 0


def _v_start(workdir: str, tag: str, backend: str, tiny: bool, local_ranks,
             gate=None, entry: str = "--v-rank"):
    """Two ranks of (v) (or of (w): `entry` "--w-rank") in spawned
    processes; `_v_wait` collects them.  With `gate`, a path, the ranks
    start their gated part once it exists."""
    import socket
    spec = {"backend": backend, "tiny": tiny, "gate": gate,
            "out": os.path.join(workdir, f"v_{tag}_rank%d.json")}
    path = os.path.join(workdir, f"v_{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank, local in enumerate(local_ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(local), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        log = open(os.path.join(workdir, f"v_{tag}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), entry, path],
            stdout=log, stderr=subprocess.STDOUT, env=env), log))
    return tag, spec, procs


def _v_wait(workdir: str, started):
    """The outputs of `_v_start`'s ranks, once both have exited."""
    tag, spec, procs = started
    try:
        for p, _ in procs:
            p.wait(timeout=600)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        with open(os.path.join(workdir, f"v_{tag}_rank{rank}.log")) as f:
            tail = f.read()[-3000:]
        require(p.returncode == 0, f"(v) {tag} rank {rank} failed:\n{tail}")
    outs = []
    for rank in range(2):
        with open(spec["out"] % rank) as f:
            outs.append(json.load(f))
        RANK_BACKWARD.append(outs[-1]["backward"])
    return outs


def _v_report_full(tag: str, outs) -> dict:
    """Hold and print the full-width parts of two ranks; the launches
    summed over them by kernel."""
    total = dict.fromkeys(_Counters.NAMES, 0)
    res = {}
    for part in ("leaf", "infonce", "siglip"):
        a, b = (o["full"][part] for o in outs)
        require(a["digest"] == b["digest"],
                f"(v) {tag} {part}: the ranks' parameters differ")
        for o in outs:
            for i, row in enumerate(o["full"][part]["steps"]):
                require(row["launches"] == row["want"],
                        f"(v) {tag} {part} rank {o['rank']} step {i + 1}: "
                        f"launches {row['launches']}, {row['want']} "
                        "expected")
                require(np.isfinite(row["loss"]) and row["loss"] > 0,
                        f"(v) {tag} {part}: loss {row['loss']}")
                for k in total:
                    total[k] += row["launches"][k]
        require([r["loss"] for r in a["steps"]]
                == [r["loss"] for r in b["steps"]],
                f"(v) {tag} {part}: the ranks logged different losses")
        steps = [{"s": max(x["s"], y["s"]),
                  "collective_s": max(x["collective_s"], y["collective_s"]),
                  "loss": x["loss"], "launches_per_rank": x["launches"]}
                 for x, y in zip(a["steps"], b["steps"])]
        share = [s["collective_s"] / s["s"] for s in steps]
        if part == "leaf":
            require(set(a["widths"]) == {16} and a["widths"] == b["widths"],
                    f"(v) {tag} leaf: probe widths {a['widths']}, "
                    f"{b['widths']}")
        say(f"(v) {tag} {part}: s per step {[round(s['s'], 4) for s in steps]}"
            f", the collectives' share {[round(x, 3) for x in share]}, "
            f"losses {[round(s['loss'], 5) for s in steps]}, launches per "
            f"rank and step {[s['launches_per_rank'] for s in steps]} held "
            "to the encodes; parameters equal bit for bit across ranks")
        res[part] = {"steps": steps, "collective_share": share}
    return total, res


def _v_world1(workdir: str) -> str:
    """`python -m leaf_tpu_torch.train.driver` at the tiny config under the
    launcher's variables at world 1 (NCCL), and with no variables: the
    losses and the parameters after 2 steps must be equal bit for bit."""
    import socket
    import torch
    flags = ["--model", V_TINY, "--dataset-type", "synthetic",
             "--train-num-samples", "8", "--batch-size", "4", "--epochs", "1",
             "--rho", "4", "--warmup", "1", "--zeroshot-frequency", "0",
             "--logs", os.path.join(workdir, "v_world1")]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    runs = {}
    for tag, env in (("launcher", dict(base, RANK="0", WORLD_SIZE="1",
                                       LOCAL_RANK="0",
                                       MASTER_ADDR="localhost",
                                       MASTER_PORT=str(port))),
                     ("plain", base)):
        log = os.path.join(workdir, f"v_world1_{tag}.log")
        with open(log, "w") as f:
            runs[tag] = (subprocess.Popen(
                [sys.executable, "-m", "leaf_tpu_torch.train.driver"] + flags
                + ["--name", tag], env=env, stdout=f,
                stderr=subprocess.STDOUT), log)
    states = {}
    for tag, (p, log) in runs.items():
        p.wait(timeout=600)
        with open(log) as f:
            require(p.returncode == 0, f"(v) world 1 {tag}: {f.read()[-3000:]}")
        run = os.path.join(workdir, "v_world1", tag)
        states[tag] = (_csv_rows(os.path.join(run, "results.csv")),
                       torch.load(os.path.join(run, "checkpoints", "epoch_1",
                                               "state.pt")))
    (rows_l, st_l), (rows_p, st_p) = states["launcher"], states["plain"]
    require(rows_l == rows_p and st_l["step"] == st_p["step"] == 2
            and all(torch.equal(v, st_p["text"][k])
                    for k, v in st_l["text"].items()),
            f"(v) world 1: the launcher's run {rows_l} differs from the "
            f"plain run {rows_p}")
    return (f"(v) world 1 on NCCL under RANK=0 WORLD_SIZE=1: losses "
            f"{[r['train_loss'] for r in rows_l]} and the parameters after 2 "
            "steps equal the run without the variables bit for bit")


def phase_multirank(workdir: str):
    """(v) two ranks (`parallel.distributed`) in spawned processes on the
    one card over gloo (NCCL refuses two ranks on one device; gloo's CUDA
    all-reduce and broadcast run in place, its all-gather and send/recv go
    through the host).  Tiny (ViT-tiny-test, fp32, TF32 off): three fused
    LEAF steps (anchors missed, every rank hits, rank 1 misses), an unfused
    step, InfoNCE global and `--local-loss`, the SigLIP ring and a FARE
    step on the card against the same two-rank runs on the CPU (losses
    within 1e-5 of their scale; parameters within 2e-4 and the key bias
    within 2 lr a step; probe widths, branches and sentences equal),
    parameters equal bit for bit across ranks.  Full width: the fused LEAF
    step at ViT-L-14-quickgelu's text tower (global batch 128, rho 50,
    bucket-16 captions) and the contrastive step at ViT-B-32 (global batch
    256) with InfoNCE and SigLIP, 2 steps each: s per step, the
    collectives' share, each rank's launches held to its encodes.  Then
    `python -m leaf_tpu_torch.train.driver` at the tiny config on NCCL
    under RANK=0 WORLD_SIZE=1, against the same run with no variables: its
    losses and parameters bit for bit.  With two or more cards the full
    width part also runs on NCCL, one card a rank.  The world-1 pair runs
    beside the ranks' tiny part; the full-width part waits for it."""
    import torch
    from leaf_tpu_torch.models.factory import get_tokenizer
    t0 = time.perf_counter()
    # the native tokenizer is built once here, not by two ranks at once
    get_tokenizer(V_TINY)("a caption")
    # the world-1 driver pair runs beside the ranks' tiny part; their
    # full-width part waits for it (the gate)
    gate = os.path.join(workdir, "v_card_free")
    ranks = _v_start(workdir, "gloo", "gloo", True, (0, 0), gate)
    try:
        world1 = _v_world1(workdir)
    finally:
        open(gate, "w").close()
        outs = _v_wait(workdir, ranks)
    for o in outs:
        require(o["world"] == 2 and o["device"] == "cuda:0",
                f"(v) rank {o['rank']}: world {o['world']} on {o['device']}")
    tiny = {}
    for part in outs[0]["tiny"]:
        a, b = (o["tiny"][part] for o in outs)
        for o, t in zip(outs, (a, b)):
            require(t["loss_err"] <= 1e-5 and t["params_err"] <= 2e-4
                    and t["same_decisions"],
                    f"(v) tiny {part} rank {o['rank']}: card vs CPU {t}")
        digests = a["digests"]
        require(digests[0] == digests[1] and a["digests"] == b["digests"],
                f"(v) tiny {part}: the ranks' parameters differ {digests}: "
                f"{a['rank_diff']}")
        require(a["losses"] == b["losses"],
                f"(v) tiny {part}: the ranks logged different losses")
        if part == "fused":
            require(a["widths"] == b["widths"] and set(a["widths"]) == {16}
                    and a["branches"] == ["full", "cached", "full"],
                    f"(v) tiny fused: widths {a['widths']} {b['widths']}, "
                    f"branches {a['branches']}")
        tiny[part] = {"loss_err": max(a["loss_err"], b["loss_err"]),
                      "params_err": max(a["params_err"], b["params_err"])}
    say(f"(v) tiny, two gloo ranks on the card against the same on the CPU "
        f"(fp32, TF32 off): {tiny}; probe widths {outs[0]['tiny']['fused']['widths']}, "
        f"branches {outs[0]['tiny']['fused']['branches']}; parameters equal "
        f"bit for bit across ranks in every part ({outs[0]['tiny_s']:.1f} s "
        "a rank, card and CPU)")
    launches, full = _v_report_full("gloo", outs)
    say(f"(v) gloo through the host on one card is no measure of NCCL: "
        f"the full-width parts took {outs[0]['full_s']:.1f} s a rank")
    results = {"tiny": tiny, "gloo": full}

    say(world1)
    if torch.cuda.device_count() >= 2:
        nccl = _v_wait(workdir, _v_start(workdir, "nccl", "nccl", False,
                                         (0, 1)))
        more, results["nccl"] = _v_report_full("nccl", nccl)
        for k in launches:
            launches[k] += more[k]
    else:
        say("(v) NCCL across cards: not run, the machine has "
            f"{torch.cuda.device_count()} card")
    results["seconds"] = time.perf_counter() - t0
    return launches, results


# ---------------------------------------------------------------------------
# (w) prefix-reuse candidate encoding, and tensor parallelism on two ranks
# ---------------------------------------------------------------------------

W_LEAF = "ViT-L-14-quickgelu"
# the prefix cell: one LEAF step's candidates at the recipe's rho, both
# phases (probes and characters), for 64 bucket-16 captions: 6,400
W_PREFIX_CAPTIONS, W_RHO = 64, 50
# the tensor-parallel cell: a (data 1, model 2) grid, two gloo ranks on the
# one card, each seeing the whole global batch of 16 captions at rho 50
W_TP_CAPTIONS, W_TP_STEPS = 16, 2
W_TINY_BATCHES = (V_TINY_CAPTIONS, V_TINY_CAPTIONS,
                  V_TINY_CAPTIONS[:4] + V_TINY_FRESH)


class _WCounters(_Counters):
    """The counters with the GEMM's, which the tensor-parallel block
    launches on its own."""
    NAMES = _Counters.NAMES + ("gemm_bias",)


def _w_tp_launches(layers: int, encodes: int) -> dict:
    """A tensor-parallel text encode's launches on each rank: per block
    ln_1 and ln_2 (LayerNorm kernel), the qkv columns and the out rows
    (GEMM kernel), its heads' attention; `ln_final` once."""
    return {"packed_attention": layers * encodes, "fused_attention_block": 0,
            "layer_norm": (2 * layers + 1) * encodes,
            "gemm_bias": 2 * layers * encodes}


def _w_candidates(tok, texts, rng, rho: int):
    """One LEAF step's candidates for `texts`: phase 1's probes (a space at
    `rho` sampled positions of each caption) and phase 2's (`rho`
    characters at the first of them), at one bucket width with the clean
    tokens.  Returns (clean [B, S], candidates [2 B rho, S], their
    captions' rows)."""
    from leaf_tpu_torch.attacks import edits
    from leaf_tpu_torch.attacks.engine import bucket_need, bucket_tokens
    space = edits.DEFAULT_VOCAB.index(ord(" "))
    n_vocab = len(edits.DEFAULT_VOCAB)
    probes, chars = [], []
    for s in texts:
        zs = edits.sample_positions(len(s), rho, rng=rng)
        probes += [edits.apply_edit(s, int(z), space, alternative=-1)
                   for z in zs]
        chars += [edits.apply_edit(s, int(zs[0]), int(u), alternative=-1)
                  for u in rng.choice(n_vocab, size=rho,
                                      replace=rho > n_vocab)]
    clean, cand = np.asarray(tok(texts)), np.asarray(tok(probes + chars))
    need = max(bucket_need(clean), bucket_need(cand))
    rows = np.tile(np.repeat(np.arange(len(texts), dtype=np.int32), rho), 2)
    return (bucket_tokens(clean, need=need), bucket_tokens(cand, need=need),
            rows)


def _w_prefix(text, clean, cand, rows, bucket: int = 4, packed=True):
    """The prefix path's features of `cand` [N, S] (normalized), its
    clean K/V from `clean`: (features, host seconds of `suffix_split`)."""
    import torch
    from leaf_tpu_torch.models import prefix_encode as pe
    t0 = time.perf_counter()
    suffix, plen = pe.suffix_split(cand, clean, rows, bucket)
    host_s = time.perf_counter() - t0
    dev = text.token_embedding.device

    def on(a):
        return torch.from_numpy(a).to(dev)
    with torch.no_grad():
        ks, vs = pe.clean_kv(text, on(clean))
        fn = pe.encode_text_suffix_packed if packed else pe.encode_text_suffix
        return fn(text, on(suffix), on(rows), on(plen), ks, vs,
                  normalize=True), host_s


def _w_prefix_tiny(counters) -> dict:
    """ViT-tiny-test, fp32, TF32 off: the prefix path (unpacked and packed)
    on the card against the card's full encode and the CPU's prefix path;
    the LayerNorm kernel's launches held (clean_kv: 2 a layer; a suffix
    encode: 2 a layer and ln_final), no attention kernel."""
    import torch
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    tok = get_tokenizer(V_TINY)
    clean, cand, rows = _w_candidates(tok, V_TINY_CAPTIONS,
                                      np.random.default_rng(3), 6)
    text = {dev: create_model(V_TINY, precision="fp32", seed=0,
                              device=dev).module.text
            for dev in ("cuda", "cpu")}
    layers = text["cuda"].cfg.layers
    with torch.no_grad():
        full = text["cuda"].encode_text(torch.from_numpy(cand).cuda(),
                                        normalize=True).cpu()
    out = {"S": int(cand.shape[1]), "N": int(cand.shape[0])}
    for packed in (False, True):
        tag = "packed" if packed else "suffix"
        torch.cuda.synchronize()
        counters.zero()
        card, _ = _w_prefix(text["cuda"], clean, cand, rows, packed=packed)
        torch.cuda.synchronize()
        got = {k: op.launches for k, op in counters.ops.items()}
        want = dict.fromkeys(_WCounters.NAMES, 0)
        want["layer_norm"] = 4 * layers + 1
        require(got == want, f"(w) tiny prefix {tag}: launches {got}, "
                f"{want} expected")
        cpu, _ = _w_prefix(text["cpu"], clean, cand, rows, packed=packed)
        card = card.cpu()
        out[tag] = {"vs_full": float((card - full).abs().max()),
                    "vs_cpu": float((card - cpu).abs().max()),
                    "launches": got}
        require(out[tag]["vs_full"] <= TOLERANCE["float32"]
                and out[tag]["vs_cpu"] <= TOLERANCE["float32"],
                f"(w) tiny prefix {tag}: {out[tag]}")
    return out


def _w_prefix_full(counters) -> dict:
    """V_LEAF's text tower (12 x 768, bf16 weights): `clean_kv` plus
    `encode_text_suffix_packed` against the packed full encode
    (`encode_text`) on one step's 6,400 bucket-16 candidates, CUDA-event
    times in turns (full, prefix, prefix, full), features at cosine >=
    0.99 of the full encode's, the LayerNorm kernel's launches held."""
    import torch
    from leaf_tpu_torch.models.clip import TextTower
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import _cast_weights, get_tokenizer
    cfg = get_model_config(W_LEAF)
    text = TextTower(cfg.text, cfg.quick_gelu)
    text.init_weights(torch.Generator().manual_seed(0))
    _cast_weights(text, torch.bfloat16)
    text = text.cuda().eval()
    layers = cfg.text.layers
    texts = _captions(np.random.default_rng(97), W_PREFIX_CAPTIONS, 3, 7)
    clean, cand, rows = _w_candidates(get_tokenizer(W_LEAF), texts,
                                      np.random.default_rng(31), W_RHO)
    require(cand.shape == (2 * W_PREFIX_CAPTIONS * W_RHO, 16),
            f"(w) prefix candidates {cand.shape}, bucket 16 expected")
    cand_dev = torch.from_numpy(cand).cuda()

    def full():
        with torch.no_grad():
            return text.encode_text(cand_dev, normalize=True)

    def prefix():
        return _w_prefix(text, clean, cand, rows)[0]

    torch.cuda.synchronize()
    counters.zero()
    feats, host_s = _w_prefix(text, clean, cand, rows)
    torch.cuda.synchronize()
    got = {k: op.launches for k, op in counters.ops.items()}
    want = dict.fromkeys(_WCounters.NAMES, 0)
    want["layer_norm"] = 4 * layers + 1
    require(got == want, f"(w) prefix launches {got}, {want} expected")
    ref = full()
    cos = torch.nn.functional.cosine_similarity(feats.float(), ref.float(),
                                                dim=-1)
    require(float(cos.min()) >= 0.99, f"(w) prefix cosine {float(cos.min())}")

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    torch.cuda.reset_peak_memory_stats()
    ms = {"full": [], "prefix": []}
    for tag in ("full", "prefix", "prefix", "full"):
        ms[tag].append(timed(full if tag == "full" else prefix))
    from leaf_tpu_torch.models import prefix_encode as pe
    suffix, plen = pe.suffix_split(cand, clean, rows, 4)
    out = {"N": int(cand.shape[0]), "S": int(cand.shape[1]),
           "T": int(suffix.shape[1]),
           "mean_suffix": float(cand.shape[1] - plen.mean()),
           "full_ms": ms["full"], "prefix_ms": ms["prefix"],
           "suffix_split_host_s": host_s, "min_cosine": float(cos.min()),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": got}
    del text, cand_dev, feats, ref
    torch.cuda.empty_cache()
    return out


def _w_tiny_steps(device, grid=None) -> dict:
    """Three fused LEAF steps at ViT-tiny-test (fp32, unpipelined; anchors
    missed, hit, half missed) on `device`, on `grid`'s shards where it is
    given: losses, sentences, the whole parameters (host copies) and their
    digest."""
    import copy
    import torch
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    from leaf_tpu_torch.parallel import sharding
    from leaf_tpu_torch.train.fused import FusedLeafStep
    from leaf_tpu_torch.train.optim import make_optimizer
    from leaf_tpu_torch.train.schedules import cosine_lr
    from leaf_tpu_torch.train.step import TrainState
    model = create_model(V_TINY, precision="fp32", seed=0, device=device,
                         master_weights=True)
    text = copy.deepcopy(model.module.text).requires_grad_(True)
    frozen = copy.deepcopy(text).requires_grad_(False)
    if grid is not None:
        sharding.shard_module(text, grid)
        sharding.shard_module(frozen, grid)
    opt = make_optimizer(text.named_parameters(), cosine_lr(V_LR, 1, 100),
                         weight_decay=1e-4, grid=grid)
    state = TrainState.create(text, opt)
    fused = FusedLeafStep(model.cfg, get_tokenizer(V_TINY), rho=4,
                          device=device, pipeline=False, grid=grid)
    rng = np.random.default_rng(7)
    losses, adv = [], []
    for texts in W_TINY_BATCHES:
        state, info = fused(state, frozen, list(texts), rng)
        losses.append(float(info["metrics"]["loss"]))
        adv.append(fused.adv_sentences(list(texts), info))
    return {"losses": losses, "adv": adv, "digest": _v_digest(text),
            "params": _u_host(text.state_dict()), "steps": len(losses)}


def _w_tp_full(grid, device, counters) -> dict:
    """One rank's full-width tensor-parallel steps: the fused LEAF step at
    V_LEAF's text tower (12 x 768, bf16 on fp32 masters) on the grid's
    shards, every rank the whole global batch (W_TP_CAPTIONS bucket-16
    captions, rho 50) and the same rng stream; per step its seconds, the
    collectives' seconds and the kernels' launches."""
    import torch
    from leaf_tpu_torch.models.clip import TextTower
    from leaf_tpu_torch.models.config import get_model_config
    from leaf_tpu_torch.models.factory import get_tokenizer
    from leaf_tpu_torch.parallel import sharding
    from leaf_tpu_torch.train.fused import FusedLeafStep
    from leaf_tpu_torch.train.optim import make_optimizer
    from leaf_tpu_torch.train.schedules import cosine_lr
    from leaf_tpu_torch.train.step import TrainState
    cfg = get_model_config(W_LEAF)
    text = TextTower(cfg.text, cfg.quick_gelu)
    text.init_weights(torch.Generator().manual_seed(0))
    frozen = TextTower(cfg.text, cfg.quick_gelu)
    frozen.load_state_dict(text.state_dict())
    towers = []
    for t in (text, frozen):
        t = sharding.shard_module(t.to(device), grid)
        t.compute_dtype = torch.bfloat16
        towers.append(t)
    text, frozen = towers
    frozen.requires_grad_(False)
    opt = make_optimizer(text.named_parameters(), cosine_lr(V_LR, 1, 100),
                         grid=grid)
    state = TrainState.create(text, opt)
    fused = FusedLeafStep(cfg, get_tokenizer(W_LEAF), rho=W_RHO,
                          device=device, grid=grid)
    texts = _captions(np.random.default_rng(97), W_TP_CAPTIONS, 3, 7)
    rng = np.random.default_rng(13)
    layers = cfg.text.layers
    rows = []
    counters.zero()
    for i in range(W_TP_STEPS):
        torch.cuda.synchronize()
        before = {k: op.launches for k, op in counters.ops.items()}
        with _VCollectives() as coll:
            t0 = time.perf_counter()
            state, info = fused(state, frozen, texts, rng)
            loss = float(info["metrics"]["loss"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        got = {k: op.launches - before[k] for k, op in counters.ops.items()}
        # anchors (missed at the first step), probes, candidates, the train
        # forward, whose backward's kernels count apart
        rows.append({"s": seconds, "collective_s": coll.seconds,
                     "collectives": coll.calls, "loss": loss,
                     "launches": got,
                     "want": _w_tp_launches(layers, 4 if i == 0 else 3)})
    return {"steps": rows, "digest": _v_digest(text),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _w_worker(spec_path: str) -> int:
    """One rank of (w), spawned by `phase_prefix_tp` (`python chip_smoke.py
    --w-rank <spec>` under the launcher's variables): a (1, 2) grid, the
    tiny steps on the card and on the CPU, then the full-width steps."""
    import torch
    from leaf_tpu_torch.parallel import distributed as D
    from leaf_tpu_torch.parallel import sharding
    with open(spec_path) as f:
        spec = json.load(f)
    info = D.init_distributed_device("cuda", backend=spec["backend"])
    grid = sharding.create_grid((1, 2))
    out = {"rank": info["rank"], "device": str(info["device"]),
           "grid": [grid.data, grid.model, grid.data_index,
                    grid.model_index]}
    # the card is the tiny reference's and the prefix cell's until then
    gate = spec.get("gate")
    while gate and not os.path.exists(gate):
        time.sleep(0.1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    counters = _WCounters()
    counters.zero()
    out["tiny"] = {"card": _w_tiny_steps(info["device"], grid)}
    torch.cuda.synchronize()
    out["tiny_launches"] = {k: op.launches for k, op in counters.ops.items()}
    out["tiny"]["cpu"] = _w_tiny_steps(torch.device("cpu"), grid)
    out["tiny_s"] = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = True
    t0 = time.perf_counter()
    out["full"] = _w_tp_full(grid, info["device"], counters)
    out["full_s"] = time.perf_counter() - t0
    # the whole parameters (tensors) beside the JSON
    torch.save({dev: out["tiny"][dev].pop("params") for dev in out["tiny"]},
               spec["out"] % info["rank"] + ".params.pt")
    out["backward"] = _backward_counts()
    with open(spec["out"] % info["rank"], "w") as f:
        json.dump(out, f, default=float)
    D.barrier()
    return 0


def phase_prefix_tp(workdir: str):
    """(w) The prefix path (`models.prefix_encode`) and tensor parallelism
    (`parallel.sharding`).  Tiny (ViT-tiny-test, fp32, TF32 off): the
    prefix path on the card equals the card's full encode and the CPU's
    prefix path; the fused LEAF step on a (1, 2) grid of two gloo ranks on
    the card equals the same grid on the CPU and the one-rank step (card and
    CPU; losses within 1e-5 of their scale, parameters within 2e-4 and the
    key bias within 2 lr a step, the same sentences), the ranks' whole
    parameters equal bit for bit.  Full width (ViT-L-14-quickgelu's text
    tower, bf16): `clean_kv` + `encode_text_suffix_packed` against
    `encode_text` on one step's 6,400 bucket-16 candidates (times in turns,
    cosine >= 0.99); the fused step at model 2, global batch 16 at rho 50,
    2 steps: s a step, the collectives' share, each rank's launches of the
    LayerNorm, GEMM and packed-attention kernels held to its encodes.
    Returns ({path: {kernel: launches}}, results)."""
    import torch
    t0 = time.perf_counter()
    from leaf_tpu_torch.models.factory import get_tokenizer
    get_tokenizer(V_TINY)("a caption")
    gate = os.path.join(workdir, "w_card_free")
    ranks = _v_start(workdir, "w", "gloo", True, (0, 0), gate, "--w-rank")
    counters = _WCounters()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tiny_prefix = _w_prefix_tiny(counters)
        one = {dev: _w_tiny_steps(torch.device(dev))
               for dev in ("cuda", "cpu")}
        torch.backends.cuda.matmul.allow_tf32 = True
        prefix = _w_prefix_full(counters)
    finally:
        open(gate, "w").close()
        outs = _v_wait(workdir, ranks)
    say(f"(w) tiny prefix path (fp32, TF32 off, {tiny_prefix['N']} "
        f"candidates at S {tiny_prefix['S']}): max abs against the card's "
        f"full encode / the CPU: unpacked "
        f"{tiny_prefix['suffix']['vs_full']:.3g} / "
        f"{tiny_prefix['suffix']['vs_cpu']:.3g}, packed "
        f"{tiny_prefix['packed']['vs_full']:.3g} / "
        f"{tiny_prefix['packed']['vs_cpu']:.3g}; launches "
        f"{tiny_prefix['packed']['launches']}")
    say(f"(w) prefix at {W_LEAF}'s text tower, bf16: {prefix['N']} "
        f"candidates at S {prefix['S']} (suffixes T {prefix['T']}, mean "
        f"{prefix['mean_suffix']:.2f} tokens): full encode ms "
        f"{[round(x, 3) for x in prefix['full_ms']]}, clean_kv + packed "
        f"suffix encode ms {[round(x, 3) for x in prefix['prefix_ms']]}, "
        f"suffix_split {prefix['suffix_split_host_s'] * 1e3:.1f} ms on the "
        f"host, min cosine {prefix['min_cosine']:.5f}, peak "
        f"{prefix['peak_gib']:.1f} GiB, launches {prefix['launches']}")
    tiny = {}
    for o in outs:
        params = torch.load(os.path.join(workdir, f"v_w_rank{o['rank']}.json"
                                         ".params.pt"))
        for dev in params:
            o["tiny"][dev]["params"] = params[dev]
        require(o["grid"][:2] == [1, 2] and o["device"] == "cuda:0",
                f"(w) rank {o['rank']}: grid {o['grid']} on {o['device']}")
        want = _w_tp_launches(2, 4 + 3 + 4)
        require(o["tiny_launches"] == want,
                f"(w) tiny rank {o['rank']}: launches {o['tiny_launches']}, "
                f"{want} expected")
        pairs = {"card vs cpu": (o["tiny"]["cpu"], o["tiny"]["card"]),
                 "card vs one rank": (one["cuda"], o["tiny"]["card"]),
                 "cpu vs one rank": (one["cpu"], o["tiny"]["cpu"])}
        for tag, (ref, got) in pairs.items():
            scale = max(abs(v) for v in ref["losses"])
            err = {"loss_err": max(abs(a - b) for a, b in zip(
                ref["losses"], got["losses"])) / scale,
                "params_err": _v_params_err(ref["params"], got["params"],
                                            got["steps"])}
            require(err["loss_err"] <= 1e-5 and err["params_err"] <= 2e-4
                    and ref["adv"] == got["adv"],
                    f"(w) tiny rank {o['rank']} {tag}: {err}, sentences "
                    f"{ref['adv'] == got['adv']}")
            tiny[tag] = {k: max(v, tiny.get(tag, {}).get(k, 0.0))
                         for k, v in err.items()}
    for dev in ("card", "cpu"):
        a, b = (o["tiny"][dev]["digest"] for o in outs)
        require(a == b, f"(w) tiny {dev}: the ranks' parameters differ")
    say(f"(w) tiny fused step on a (1, 2) grid of two gloo ranks (fp32, TF32 "
        f"off): {tiny}; the same sentences; each rank's launches over the "
        f"three steps {outs[0]['tiny_launches']}; whole parameters equal bit "
        f"for bit across ranks ({outs[0]['tiny_s']:.1f} s a rank)")

    a, b = (o["full"] for o in outs)
    require(a["digest"] == b["digest"],
            "(w) model 2: the ranks' parameters differ")
    launches = dict.fromkeys(_WCounters.NAMES, 0)
    for o in outs:
        for i, row in enumerate(o["full"]["steps"]):
            require(row["launches"] == row["want"],
                    f"(w) model 2 rank {o['rank']} step {i + 1}: launches "
                    f"{row['launches']}, {row['want']} expected")
            require(np.isfinite(row["loss"]) and row["loss"] > 0,
                    f"(w) model 2: loss {row['loss']}")
            for k in launches:
                launches[k] += row["launches"][k]
    require([r["loss"] for r in a["steps"]] == [r["loss"] for r in b["steps"]],
            "(w) model 2: the ranks logged different losses")
    steps = [{"s": max(x["s"], y["s"]),
              "collective_s": max(x["collective_s"], y["collective_s"]),
              "collectives": x["collectives"], "loss": x["loss"],
              "launches_per_rank": x["launches"]}
             for x, y in zip(a["steps"], b["steps"])]
    share = [s["collective_s"] / s["s"] for s in steps]
    say(f"(w) model 2 at {W_LEAF}'s text tower (bf16 on fp32 masters, global "
        f"batch {W_TP_CAPTIONS}, rho {W_RHO}): s per step "
        f"{[round(s['s'], 4) for s in steps]}, the collectives' share "
        f"{[round(x, 3) for x in share]} ({steps[0]['collectives']} calls a "
        f"step, gloo through the host), losses "
        f"{[round(s['loss'], 5) for s in steps]}, launches per rank and step "
        f"{[s['launches_per_rank'] for s in steps]} held to the encodes; "
        f"whole parameters equal bit for bit across ranks; peak "
        f"{max(a['peak_gib'], b['peak_gib']):.1f} GiB a rank")
    results = {"tiny_prefix": tiny_prefix, "prefix": prefix, "tiny_tp": tiny,
               "tp": {"steps": steps, "collective_share": share},
               "seconds": time.perf_counter() - t0}
    paths = {"prefix": {"layer_norm": tiny_prefix["packed"]["launches"][
                 "layer_norm"] + prefix["launches"]["layer_norm"]},
             "tp": launches}
    return paths, results


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
        with _depth_cut():
            with _BackwardGuard("j"):
                train_launches, trainer = _timed("j", phase_train, workdir)
            with _BackwardGuard("k"):
                eval_parity = _timed("k parity", phase_eval_parity, workdir)
                eval_launches, recipe = _timed("k", phase_recipe, workdir)
            charmer_parity = _timed("l parity", phase_charmer_parity,
                                    workdir)
            attack_launches, text_attacks = _timed("l", phase_text_attacks,
                                                   workdir)
            with _BackwardGuard("m"):
                fare_parity = _timed("m parity", phase_fare_parity, workdir)
                fare_launches, fare_runs = _timed("m FARE", phase_fare,
                                                  workdir)
                robust_launches, robust = _timed("m robust", phase_robust,
                                                 workdir)
            with _BackwardGuard("n"):
                clip_parity = _timed("n parity", phase_contrastive_parity,
                                     workdir)
                clip_launches, clip_runs = _timed("n", phase_contrastive,
                                                  workdir)
            with _BackwardGuard("o"):
                bench_parity = _timed("o parity", phase_benchmark_parity,
                                      workdir)
                bench_launches, pez_launches, bench_runs = _timed(
                    "o", phase_benchmark, workdir)
            t2i_parity = _timed("p parity", phase_t2i_parity, workdir)
            t2i_launches, t2i_runs = _timed("p", phase_t2i_tooling, workdir)
        coca_parity = _timed("q parity", phase_coca_parity, workdir)
        with _coca_depth_cut():
            coca_launches, coca_runs = _timed("q", phase_coca, workdir)
        zoo_parity = _timed("r parity", phase_zoo_parity, workdir)
        with _depth_cut(ZOO_DEPTH_CUTS, "(r)"):
            zoo_launches, zoo_runs = _timed("r", phase_zoo, workdir)
        conv_parity = _timed("s parity", phase_convnet_parity, workdir)
        conv_launches, conv_runs = _timed("s", phase_convnets, workdir)
        rest_parity = _timed("t parity", phase_rest_parity, workdir)
        rest_launches, rest_runs = _timed("t", phase_rest, workdir)
        with _BackwardGuard("u"):
            train_parity = _timed("u parity", phase_zoo_train_parity,
                                  workdir)
            train_zoo_launches, train_zoo_runs = _timed(
                "u", phase_zoo_train, workdir)
        with _BackwardGuard("v"):
            rank_launches, multirank = _timed("v", phase_multirank, workdir)
        with _BackwardGuard("w"):
            w_launches, prefix_tp = _timed("w", phase_prefix_tp, workdir)
        zoo_launches = {**zoo_launches, **conv_launches, **rest_launches,
                        **train_zoo_launches,
                        "multirank": rank_launches}
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
                                for path in t2i_launches},
                             **{path: coca_launches[path]["packed_attention"]
                                for path in coca_launches},
                             **{path: zoo_launches[path]["packed_attention"]
                                for path in zoo_launches},
                             "tensor_parallel":
                                 w_launches["tp"]["packed_attention"]},
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
               for path in t2i_launches},
            **{path: coca_launches[path]["fused_attention_block"]
               for path in coca_launches},
            **{path: zoo_launches[path]["fused_attention_block"]
               for path in zoo_launches}},
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
                      for path in t2i_launches},
                   **{path: coca_launches[path]["layer_norm"]
                      for path in coca_launches},
                   **{path: zoo_launches[path]["layer_norm"]
                      for path in zoo_launches},
                   "prefix_encode": w_launches["prefix"]["layer_norm"],
                   "tensor_parallel": w_launches["tp"]["layer_norm"]}
    for path, count in ln_launches.items():
        require(count > 0, f"layer_norm: no launch on the {path} path")
    # the GEMM alone: the tensor-parallel block's qkv columns and out rows
    gemm_launches = {"tensor_parallel": w_launches["tp"]["gemm_bias"]}
    require(gemm_launches["tensor_parallel"] > 0,
            "gemm_bias: no launch on the tensor_parallel path")
    require(report[1]["name"] == "fused_attention_block", "report order")
    report[1]["parts"] = {
        "layer_norm": {"launches": sum(ln_launches.values()),
                       "launches_by_path": ln_launches},
        "gemm_bias": {"launches": sum(gemm_launches.values()),
                      "launches_by_path": gemm_launches}}
    # the backward kernels, launched by the guarded phases' differentiated
    # steps (BACKWARD), at FARE's ViT-H shapes; the block's backward (its
    # recompute, cuBLAS products and these kernels) by path beside the block
    block_backward = {tag: c["fused_attention_block"]
                      for tag, c in BACKWARD.items()}
    report[1]["backward"] = {"launches": sum(block_backward.values()),
                             "launches_by_path": block_backward}
    for name, key, source, replaces, main_shape in (
            ("packed_attention_backward", "packed_attention",
             "leaf_tpu_torch/ops/csrc/attention_backward.cu",
             "leaf_tpu/ops/packed_attention.py:187", BWD_MAIN_SHAPE),
            ("layer_norm_backward", "layer_norm",
             "leaf_tpu_torch/ops/csrc/layer_norm_backward.cu",
             "leaf_tpu/ops/packed_attention.py:363", LN_BWD_MAIN_SHAPE)):
        by_path = {tag: c[key] for tag, c in BACKWARD.items()}
        for path, count in by_path.items():
            require(count > 0, f"{name}: no launch on the ({path}) path")
        by_shape = parts[name]
        main_row = next(r for r in by_shape if r["shape"] == main_shape)
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "dtype": main_row["dtype"]})
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
                      "t2i": t2i_runs, "coca_parity": coca_parity,
                      "coca": coca_runs, "zoo_parity": zoo_parity,
                      "zoo": zoo_runs, "convnets_parity": conv_parity,
                      "convnets": conv_runs, "rest_parity": rest_parity,
                      "rest": rest_runs, "zoo_train_parity": train_parity,
                      "zoo_train": train_zoo_runs,
                      "multirank": multirank, "prefix_tp": prefix_tp,
                      "backward": BACKWARD},
                     default=float))
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
    if sys.argv[1:2] == ["--v-rank"]:
        sys.exit(_v_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--w-rank"]:
        sys.exit(_w_worker(sys.argv[2]))
    sys.exit(main())
