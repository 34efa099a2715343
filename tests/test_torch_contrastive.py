"""leaf_tpu_torch's contrastive CLIP trainer against the JAX package's, in
fp32 on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's copy
by way of `interop.params_from_jax`, the command lines' by one OpenCLIP
checkpoint written from it), with the same images and captions from
numpy.  Held: the three losses (values 1e-5, gradients 1e-4 / 1e-6, the
tolerances of tests/test_loss.py); the lock multipliers of every case of
tests/test_locking.py and a locked step under a clip that bites; two
steps each of the plain, SigLIP, feature-cache (k = 2) and distillation
steps (loss 1e-5 relative, parameters 1e-4 at lr 1e-4); patch dropout
given JAX's scores; `get_clip_metrics` and `evaluate_contrastive`;
`contrastive_driver.main` against the JAX command line on tar shards (the
same results.csv rows, a resume to the same step) and on synthetic
captions with each variant; the LEAF driver's `--val-data` metrics; the
refusals; the port's own copies of its data files.
"""
import argparse
import csv
import dataclasses
import hashlib
import io
import os
import sys
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import get_tokenizer as jget_tokenizer
from leaf_tpu.models import loss as jloss
from leaf_tpu.train import contrastive as jcon
from leaf_tpu.train import contrastive_driver as jcdriver
from leaf_tpu.train import driver as jdriver
from leaf_tpu.train import locking as jlock
from leaf_tpu.train.optim import make_optimizer as jmake_optimizer
from leaf_tpu.train.step import TrainState
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import loss as tloss
from leaf_tpu_torch.models import zero_shot as tzs
from leaf_tpu_torch.models.factory import get_tokenizer
from leaf_tpu_torch.tokenizer import bpe as tbpe
from leaf_tpu_torch.train import contrastive as tcon
from leaf_tpu_torch.train import contrastive_driver as tcdriver
from leaf_tpu_torch.train import driver as tdriver
from leaf_tpu_torch.train import locking as tlock
from leaf_tpu_torch.train.optim import global_norm, make_optimizer
from leaf_tpu_torch.train.params import parse_args

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
LR = 1e-4
CAPTIONS = ["a photo of a cat", "a red car on the street",
            "two dogs running in a park", "an old man reading",
            "a bowl of soup", "boats on a river at dusk",
            "a child with a kite", "snow on the mountains"]


def _module(params, cfg=None):
    module = tclip.CLIP(cfg or tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return module.eval()


@pytest.fixture(scope="module")
def pair():
    """(JAX params, JAX config, a teacher's JAX params, images [2, 4, 64,
    64, 3], tokens [2, 4, 77]): two batches of 4."""
    cfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), cfg)
    teacher = jclip.init_clip(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 4, 64, 64, 3)).astype(np.float32)
    tokens = np.asarray(get_tokenizer(MODEL)(CAPTIONS)).reshape(2, 4, -1)
    return params, cfg, teacher, images, tokens


def _assert_params_close(module, params, steps, atol=1e-4, lr=LR):
    """Every parameter within `atol`, but the attention's key bias within
    2 lr a step: its true gradient is zero (softmax is shift invariant),
    and Adam turns each framework's rounding noise there into a step of up
    to lr either way (ROADMAP Queue 3)."""
    want = tinterop.params_from_jax(jax.tree.map(np.asarray, params))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].detach().numpy(), want[k].numpy()
        if k.endswith("attn.qkv_b"):
            d = g.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d],
                                       atol=2 * steps * lr, err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["clip", "siglip", "distill"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(2)
    args = [_unit(rng, 6, 16), _unit(rng, 6, 16), np.float32(14.3)]
    if name == "distill":
        args += [_unit(rng, 6, 16), _unit(rng, 6, 16), np.float32(9.1)]

    def jfn(*a):
        if name == "clip":
            return jloss.clip_loss(*a)
        if name == "siglip":
            return jloss.siglip_loss(*a)
        c, d = jloss.distill_clip_loss(*a)
        return c + d

    def tfn(*a):
        if name == "clip":
            return tloss.clip_loss(*a)
        if name == "siglip":
            return tloss.siglip_loss(*a)
        c, d = tloss.distill_clip_loss(*a)
        return c + d

    jval, jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        *map(jnp.asarray, args))
    leaves = [torch.tensor(a, requires_grad=i < 3)
              for i, a in enumerate(args)]
    tval = tfn(*leaves)
    tval.backward()
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    for leaf, g in zip(leaves[:3], jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6)


def test_create_loss_picks_by_flags():
    assert tloss.create_loss(parse_args([])) is tloss.clip_loss
    assert tloss.create_loss(parse_args(["--siglip"])) is tloss.siglip_loss
    coca = tloss.create_loss(parse_args(["--model", "coca_ViT-B-32",
                                         "--coca-caption-loss-weight", "3"]))
    assert coca.func is tloss.coca_loss and coca.keywords == {
        "caption_loss_weight": 3.0, "clip_loss_weight": 1.0}


# ---------------------------------------------------------------------------
# locking
# ---------------------------------------------------------------------------

LOCK_CASES = [
    dict(lock_image=True),
    dict(lock_image=True, lock_image_unlocked_groups=1),
    dict(lock_image=True, lock_image_unlocked_groups=2),
    dict(lock_image=True, lock_image_unlocked_groups=3),
    dict(lock_image=True, lock_image_unlocked_groups=4),
    dict(lock_text=True),
    dict(lock_text=True, lock_text_unlocked_layers=1),
    dict(lock_text=True, lock_text_freeze_layer_norm=False),
    dict(lock_text=True, lock_text_unlocked_layers=1,
         lock_text_freeze_layer_norm=False),
    dict(lock_image=True, lock_text=True, lock_text_unlocked_layers=2),
]


@pytest.mark.parametrize("case", LOCK_CASES, ids=lambda c: "-".join(
    f"{k[5:]}={v}" for k, v in c.items()))
def test_lock_multipliers_match_jax(pair, case):
    params = pair[0]
    jmult = jlock.lock_multipliers(params, **case)
    # the JAX multipliers broadcast to each parameter's shape, then
    # un-stacked like the parameters: one value per port parameter
    full = jax.tree.map(lambda m, p: np.broadcast_to(np.asarray(m), p.shape),
                        jmult, params)
    want = {k: np.unique(v.numpy()) for k, v in
            tinterop.params_from_jax(full).items()}
    got = tlock.lock_multipliers(_module(params), **case)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert v.tolist() == [got[k]], k


def test_locked_step_under_clip_matches_jax(pair):
    """`--lock-image --lock-text --lock-text-unlocked-layers 1` under a
    clip of 0.05 that bites: the locked gradients count in the global
    norm, so the unlocked parameters' steps equal JAX's; the locked
    parameters stay bit for bit.  Adam's eps of 1 and lr of 1 make the
    step linear in the clipped gradient (at the default eps Adam's step
    would hardly see the clip's scale)."""
    params, cfg, _, images, tokens = pair
    case = dict(lock_image=True, lock_text=True, lock_text_unlocked_layers=1)
    lr, eps = 1.0, 1.0
    tx = jlock.apply_locking(
        jmake_optimizer(lambda s: lr, grad_clip_norm=0.05, weight_decay=0.2,
                        eps=eps),
        params, argparse.Namespace(**case))
    jstep = jcon.make_contrastive_train_step(cfg, tx)
    jstate = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    module = _module(params)
    x, t = torch.from_numpy(images[0]), torch.from_numpy(tokens[0])
    # the clip bites: the gradients' global norm is far above 0.05
    tcon.contrastive_loss_fn(module, x, t).backward()
    assert float(global_norm(p.grad for p in module.parameters())) > 0.5
    module.zero_grad(set_to_none=True)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    mult = tlock.lock_multipliers(module, **case)
    opt = make_optimizer(module.named_parameters(), lambda s: lr,
                         grad_clip_norm=0.05, eps=eps, multipliers=mult)
    state = tcon.ContrastiveState(module, opt)
    step = tcon.make_contrastive_train_step()
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images[0]),
                           jnp.asarray(tokens[0]))
        state, tm = step(state, x, t)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    _assert_params_close(module, jstate.text_params, 2, lr=lr)
    after = module.state_dict()
    for k, m in mult.items():
        if m == 0.0:
            assert torch.equal(after[k], before[k]), k
    assert sum(m == 0.0 for m in mult.values()) > 0
    assert not torch.equal(after["text.blocks.1.mlp.fc_w"],
                           before["text.blocks.1.mlp.fc_w"])


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["plain", "siglip", "accum", "distill",
                                  "accum-linear"])
def test_train_steps_match_jax(pair, kind):
    """Two steps of each against JAX at lr 1e-4.  "accum-linear" runs the
    feature-cache step with Adam's eps and lr at 1, where the step is
    linear in the gradient: a mean of the chunk gradients in place of
    their sum would halve it (at the default eps Adam's step would hardly
    see the scale)."""
    params, cfg, teacher, images, tokens = pair
    lr, eps = (1.0, 1.0) if kind == "accum-linear" else (LR, 1e-6)
    tx = jmake_optimizer(lambda s: lr, weight_decay=0.2, eps=eps)
    jstate = TrainState.create(jax.tree.map(jnp.copy, params), tx)
    module = _module(params)
    state = tcon.ContrastiveState(
        module, make_optimizer(module.named_parameters(), lambda s: lr,
                               eps=eps))
    if kind.startswith("accum"):
        jstep = jcon.make_accum_contrastive_train_step(cfg, tx, 2)
        step = tcon.make_accum_contrastive_train_step()
        batches = [(images, tokens)] * 2
    elif kind == "distill":
        jfn = jcdriver.make_distill_train_step(cfg, cfg, tx)

        def jstep(s, im, tk):
            return jfn(s, teacher, im, tk)
        step = tcdriver.make_distill_train_step(_module(teacher))
        batches = list(zip(images, tokens))
    else:
        jstep = jcon.make_contrastive_train_step(cfg, tx,
                                                 siglip=kind == "siglip")
        step = tcon.make_contrastive_train_step(siglip=kind == "siglip")
        batches = list(zip(images, tokens))
    for im, tk in batches:
        jstate, jm = jstep(jstate, jnp.asarray(im), jnp.asarray(tk))
        state, tm = step(state, torch.from_numpy(im), torch.from_numpy(tk))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert state.step == 2
    _assert_params_close(module, jstate.text_params, 2, lr=lr)


def test_logit_scale_clamped():
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    with torch.no_grad():
        module.logit_scale.fill_(7.0)
    tcon.clamp_logit_scale(module)
    assert float(module.logit_scale) == pytest.approx(np.log(100.0))


def test_patch_dropout_matches_jax(pair):
    """JAX's draw for a fixed key, given to the port as its scores: the
    same kept tokens and the same image features."""
    params, cfg, _, images, _ = pair
    key = jax.random.PRNGKey(7)
    x = np.random.default_rng(3).standard_normal((4, 17, 8)).astype(
        np.float32)
    scores = np.asarray(jax.random.uniform(key, (4, 16)))
    want = np.asarray(jclip.patch_dropout(jnp.asarray(x), 0.5, key))
    got = tclip.keep_patches(torch.from_numpy(x), 0.5,
                             torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (4, 9, 8)
    tcfg = tconfig.get_model_config(MODEL)
    tcfg = dataclasses.replace(tcfg, vision=dataclasses.replace(
        tcfg.vision, patch_dropout=0.5))
    visual = _module(params, tcfg).visual
    want = jclip.encode_image(params["visual"], cfg.vision,
                              jnp.asarray(images[0]),
                              patch_dropout_rate=0.5, dropout_key=key)
    with torch.no_grad():
        got = visual.encode_image(torch.from_numpy(images[0]),
                                  dropout=torch.from_numpy(scores))
        plain = visual.encode_image(torch.from_numpy(images[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)
    s = tclip.patch_dropout_scores(17, 3, 4, 16, "cpu")
    assert torch.equal(s, tclip.patch_dropout_scores(17, 3, 4, 16, "cpu"))
    assert not torch.equal(s, tclip.patch_dropout_scores(17, 4, 4, 16, "cpu"))


# ---------------------------------------------------------------------------
# metrics and the val eval
# ---------------------------------------------------------------------------

def test_clip_metrics_and_evaluate_match_jax(pair):
    params, cfg, _, images, tokens = pair
    rng = np.random.default_rng(4)
    img, txt = _unit(rng, 12, 8), _unit(rng, 12, 8)
    assert tcon.get_clip_metrics(img, txt, 3.0) == \
        jcon.get_clip_metrics(img, txt, 3.0)
    loader = [(images[i], CAPTIONS[4 * i:4 * i + 4]) for i in range(2)]
    want = jcon.evaluate_contrastive(params, cfg, loader,
                                     jget_tokenizer(MODEL))
    got = tcon.evaluate_contrastive(_module(params), loader,
                                    get_tokenizer(MODEL))
    assert sorted(got) == sorted(want) and got["num_samples"] == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert tcon.evaluate_contrastive(_module(params), [],
                                     get_tokenizer(MODEL)) == {}


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _write_shards(root, rng, shards=2, per_shard=8, size=72):
    """Tar shards of PNG images and distinct captions; returns the brace
    spec."""
    os.makedirs(root)
    for s in range(shards):
        with tarfile.open(os.path.join(root, f"{s:03d}.tar"), "w") as tf:
            for i in range(per_shard):
                png = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                             dtype=np.uint8)).save(png, "PNG")
                cap = f"{CAPTIONS[i]} number {s * per_shard + i}".encode()
                for ext, payload in (("png", png.getvalue()), ("txt", cap)):
                    info = tarfile.TarInfo(f"s{s}_{i:03d}.{ext}")
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
    return os.path.join(root, "{000..%03d}.tar" % (shards - 1))


@pytest.fixture(scope="module")
def files(pair, tmp_path_factory):
    """An OpenCLIP checkpoint of the shared weights, train shards, a val
    shard."""
    root = tmp_path_factory.mktemp("contrastive")
    module = _module(pair[0])
    ckpt = str(root / "init")
    save_state_dict(params_to_openclip(module.state_dict(), module.cfg),
                    ckpt, "openclip")
    rng = np.random.default_rng(8)
    train = _write_shards(str(root / "train"), rng)
    val = _write_shards(str(root / "val"), rng, shards=1)
    return ckpt, train, val


def _rows(out_dir):
    with open(os.path.join(out_dir, "results.csv"), newline="") as f:
        return list(csv.DictReader(f))


def _assert_rows_close(got, want):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k] in ("", "nan"):
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(float(g[k]), float(w[k]),
                                           rtol=1e-4, atol=1e-6, err_msg=k)


def test_contrastive_driver_matches_jax(files, tmp_path):
    """Tar shards through the random-resized-crop pipeline, `--val-data`,
    the cosine schedule, 1 epoch, then `--resume latest --epochs 2`: the
    same results.csv rows (train loss and every val metric) and the same
    step."""
    ckpt, train, val = files
    flags = ["--model", MODEL, "--pretrained", ckpt, "--train-data", train,
             "--dataset-type", "webdataset", "--train-num-samples", "16",
             "--batch-size", "8", "--val-data", val, "--workers", "1",
             "--lr", "1e-4", "--warmup", "1", "--log-every-n-steps", "1",
             "--aug-cfg", "scale=(0.5,1.0)", "gray_scale_prob=0.5",
             "color_jitter=(0.4,0.4,0.4,0.1)", "color_jitter_prob=0.8"]
    outs = {}
    for name, main, extra in (("jax", jcdriver.main, []),
                              ("torch", tcdriver.main, ["--device", "cpu"])):
        run = ["--logs", str(tmp_path), "--name", name]
        main(flags + run + extra + ["--epochs", "1"])
        outs[name] = main(flags + run + extra
                          + ["--epochs", "2", "--resume", "latest"])
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "torch")
    assert [r["epoch"] for r in got] == ["0", "1", "2"]
    _assert_rows_close(got, want)
    assert 0 <= float(got[2]["image_to_text_R@1"]) <= 1
    assert outs["torch"]["state"].step == int(outs["jax"]["state"].step) == 4
    assert sorted(os.listdir(tmp_path / "torch" / "checkpoints")) == \
        ["epoch_1", "epoch_2"]
    assert len(outs["torch"]["times"]) == 2


SYNTHETIC = ["--model", MODEL, "--dataset-type", "synthetic",
             "--train-num-samples", "32", "--batch-size", "8", "--epochs",
             "1", "--lr", "1e-4", "--device", "cpu"]


@pytest.mark.parametrize("extra, loss", [
    ([], np.log(8)), (["--accum-freq", "2"], np.log(16)),
    (["--distill-model", MODEL], 2 * np.log(8)),
    (["--force-patch-dropout", "0.5"], np.log(8)),
    (["--lock-image"], np.log(8))],
    ids=["plain", "accum", "distill", "patch-dropout", "lock-image"])
def test_command_line_variants(extra, loss, tmp_path):
    """The acceptance command line and its variants on the synthetic
    captions: every sample is the same black image and caption, so every
    row of the logits is the same, InfoNCE is ln(batch) and the
    distillation term ln(batch) too, whatever the weights: the JAX
    driver's rows (2.0794413, 2.7725887, 4.1588826, 2.0794458, 2.0794413
    with the same flags)."""
    out = tcdriver.main(SYNTHETIC + extra + ["--logs", str(tmp_path),
                                             "--name", "run"])
    rows = _rows(tmp_path / "run")
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert rows[0]["train_loss"] == "nan"
    np.testing.assert_allclose(float(rows[1]["train_loss"]), loss, rtol=1e-5)
    assert out["state"].step == (2 if "--accum-freq" in extra else 4)
    if "--lock-image" in extra:
        init = tclip.CLIP(out["cfg"])
        init.init_weights(torch.Generator().manual_seed(0))
        final = out["model"].module.visual.state_dict()
        assert all(torch.equal(v, final[k])
                   for k, v in init.visual.state_dict().items())


def test_imagenet_val_columns(tmp_path, monkeypatch):
    """`--imagenet-val` fills the two zero-shot columns of the epoch-0 and
    the last row (un-normalised images, normalised on the device); the
    classifier is cut to 2 of its 80 templates to keep the test short."""
    from leaf_tpu_torch.evals import zero_shot as tzeval
    monkeypatch.setattr(tzeval, "openai_imagenet_templates",
                        lambda: tzs.openai_imagenet_templates()[:2])
    rng = np.random.default_rng(10)
    for c in range(2):
        os.makedirs(tmp_path / "val" / f"c{c}")
        for i in range(2):
            np.save(tmp_path / "val" / f"c{c}" / f"{i}.npy",
                    rng.integers(0, 256, (70, 70, 3), dtype=np.uint8))
    tcdriver.main(SYNTHETIC + ["--imagenet-val", str(tmp_path / "val"),
                               "--zeroshot-frequency", "1", "--logs",
                               str(tmp_path), "--name", "run"])
    rows = _rows(tmp_path / "run")
    for r in rows:
        top1 = float(r["imagenet-zeroshot-val-top1"])
        assert 0 <= top1 <= float(r["imagenet-zeroshot-val-top5"]) <= 1


def test_siglip_command_line_matches_jax(files, tmp_path):
    """`--siglip` on the synthetic captions from the shared checkpoint: the
    sigmoid loss of identical rows depends on the weights, and equals the
    JAX driver's."""
    flags = SYNTHETIC[:-2] + ["--pretrained", files[0], "--siglip",
                              "--logs", str(tmp_path)]
    jcdriver.main(flags + ["--name", "jax"])
    tcdriver.main(flags + ["--name", "torch", "--device", "cpu"])
    _assert_rows_close(_rows(tmp_path / "torch"), _rows(tmp_path / "jax"))


def test_command_line_refusals(tmp_path, monkeypatch):
    base = SYNTHETIC + ["--logs", str(tmp_path)]
    for extra, err, match in [
            # ported since this case was written: one entry, the number
            # of ranks (1 runs below)
            (["--mesh-shape", "2"], ValueError, "mesh-shape"),
            # the overrides and registry tags are taken since these cases
            # were written: --force-image-size refuses CoCa as in JAX, and
            # a tag resolves from the local checkpoint cache, where
            # 'openai' has no ViT-tiny-test file
            (["--force-image-size", "32", "--model", "coca-tiny-test"],
             ValueError, "CoCa"),
            (["--pretrained", "openai"], FileNotFoundError, "registry tag"),
            (["--aug-cfg", "color_jitter_prob=0.8"], ValueError,
             "color_jitter"),
            (["--no-gather-with-grad"], ValueError, "gather"),
            (["--grad-checkpointing"], ValueError, "grad-checkpointing"),
            (["--distill-model", MODEL, "--siglip"], ValueError, "siglip"),
            (["--distill-model", MODEL, "--accum-freq", "2"], ValueError,
             "accum"),
            (["--distill-model", "ViT-S-32"], ValueError, "resolution"),
            (["--siglip", "--accum-freq", "2"], ValueError, "InfoNCE"),
            (["--force-patch-dropout", "0.5", "--accum-freq", "2"],
             ValueError, "patch-dropout")]:
        with pytest.raises(err, match=match):
            tcdriver.main(base + extra)
    # CoCa trains since these cases were written (tests/test_torch_coca.py),
    # its HF-text configs too (tests/test_torch_zoo_contrastive.py); what
    # refuses here is their tokenizer, which needs files that neither
    # machine has, where the JAX driver tokenizes every CoCa model with
    # the CLIP BPE
    with pytest.raises(NotImplementedError, match="HF tokenizer"):
        tcdriver.main(["--model", "coca-roberta-tiny-test", "--device", "cpu"])
    # ported since these cases were written, one case each: --report-to
    # wandb without the package logs the JAX package's warning and trains
    # untracked; --remote-sync mirrors the run; --copy-codebase snapshots
    # the package
    monkeypatch.setitem(sys.modules, "wandb", None)
    mirror = tmp_path / "mirror"
    out = tcdriver.main(base + ["--report-to", "wandb", "--remote-sync",
                                str(mirror), "--copy-codebase", "--name",
                                "taken", "--force-image-size", "32",
                                "--force-quick-gelu", "--image-mean", "0.5",
                                "0.5", "0.5", "--image-interpolation",
                                "bilinear", "--image-resize-mode", "squash",
                                "--mesh-shape", "1"])
    run = tmp_path / "taken"
    assert [r["epoch"] for r in out["results"]] == [0, 1]
    cfg = out["model"].cfg
    assert (cfg.vision.image_size, cfg.quick_gelu, cfg.image_mean) == (
        32, True, (0.5, 0.5, 0.5))
    assert (mirror / "taken" / "results.csv").read_text() == \
        (run / "results.csv").read_text()
    assert (mirror / "taken" / "checkpoints" / "epoch_1" / "state.pt").exists()
    assert (run / "code" / "leaf_tpu_torch" / "serve.py").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcdriver.main(SYNTHETIC[:-2] + ["--logs", str(tmp_path)])


def test_leaf_driver_val_data_matches_jax(files, tmp_path):
    """The LEAF driver with `--val-data` and nothing to train: the epoch-0
    eval's val metrics (images normalised on the device) equal the JAX
    driver's; `get_data` builds the val split."""
    ckpt, _, val = files
    flags = ["--model", MODEL, "--pretrained", ckpt, "--val-data", val,
             "--batch-size", "4", "--zeroshot-frequency", "0",
             "--workers", "1"]
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, module, target in (
                ("jax", jcon, jcon), ("torch", tcon, tdriver)):
            inner = module.evaluate_contrastive

            def recording(*a, _inner=inner, _name=name, **kw):
                seen[_name] = _inner(*a, **kw)
                return seen[_name]
            mp.setattr(target, "evaluate_contrastive", recording)
        jdriver.main(flags + ["--logs", str(tmp_path), "--name", "jax"])
        out = tdriver.main(flags + ["--logs", str(tmp_path), "--name",
                                    "torch", "--device", "cpu"])
    assert seen["torch"]["num_samples"] == 8
    assert sorted(seen["torch"]) == sorted(seen["jax"])
    for k, v in seen["jax"].items():
        np.testing.assert_allclose(seen["torch"][k], v, rtol=1e-4, err_msg=k)
    assert 0 <= seen["torch"]["image_to_text_R@1"] <= 1
    assert "clip_val_loss" not in out["results"][0]


def test_npy_members_decode_without_pillow(monkeypatch):
    """A tar sample's `.npy` image (the card machine has no Pillow) goes
    through the transform like a decoded PNG of the same pixels."""
    import sys
    from leaf_tpu_torch.data import wds as twds
    from leaf_tpu_torch.models.preprocess import image_transform
    arr = np.random.default_rng(9).integers(0, 256, (40, 30, 3),
                                            dtype=np.uint8)
    npy, png = io.BytesIO(), io.BytesIO()
    np.save(npy, arr)
    Image.fromarray(arr).save(png, "PNG")
    pre = image_transform(32)
    want = twds.decode_sample({"txt": b"a cat", "png": png.getvalue()}, pre)
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = twds.decode_sample({"txt": b"a cat", "npy": npy.getvalue()}, pre)
    assert got["text"] == "a cat"
    np.testing.assert_array_equal(got["image"], want["image"])


# ---------------------------------------------------------------------------
# the port's own data files
# ---------------------------------------------------------------------------

def test_data_files_are_the_ports_own():
    """The BPE vocabulary and the zero-shot metadata are read from the
    port's copies, byte-equal to the JAX package's, and the ids of fixed
    captions stay what they were."""
    port = os.path.dirname(os.path.abspath(tcdriver.__file__))
    port = os.path.dirname(port)
    jax_assets = os.path.join(os.path.dirname(port), "leaf_tpu", "models",
                              "assets")
    for path in (tbpe.DEFAULT_BPE_PATH, tzs._ASSET):
        assert os.path.abspath(path).startswith(port + os.sep)
        with open(path, "rb") as f, open(os.path.join(
                jax_assets, os.path.basename(path)), "rb") as g:
            assert hashlib.sha256(f.read()).hexdigest() == \
                hashlib.sha256(g.read()).hexdigest()
    tok = get_tokenizer(MODEL)(CAPTIONS[:3])
    np.testing.assert_array_equal(tok, np.asarray(
        jget_tokenizer(MODEL)(CAPTIONS[:3])))
    np.testing.assert_array_equal(
        tok[0, :7], [49406, 320, 1125, 539, 320, 2368, 49407])
    assert len(tzs.imagenet_classnames()) == 1000
