"""leaf_tpu_torch's FARE trainer and ImageNet robust eval against the JAX
package's, in fp32 on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's copy
by way of `interop.params_from_jax`, the command lines' by one OpenCLIP
checkpoint written from it), with the same images from numpy.  Held: the
vision tower's bf16 compute on fp32 weights and its `remat`, GELU;
`embedding_loss` for every loss to 1e-5; `make_fare_optimizer` (AdamW,
SGD, the clip) the optax chain's parameters after 3 steps; the attack
(PGD from JAX's start, APGD), the train step and `train_fare` over 2 steps
to 1e-4; `fare_driver.main` the JAX command line's per-step losses and
parameters over 2 steps and a resume to 4; `imagenet_robust.main` the JAX
command line's `results.json` with and without `--square`; the command
lines' checkpoints, fallbacks and refusals.
"""
import json
import os
import sys

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from leaf_tpu.attacks import square as jsquare
from leaf_tpu.evals import imagenet_robust as jir
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import layers as jlayers
from leaf_tpu.models import zero_shot as jzs
from leaf_tpu.train import fare as jfare
from leaf_tpu.train import fare_driver as jdriver
from leaf_tpu.train.step import TrainState
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.evals import imagenet_robust as tir
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import layers as tlayers
from leaf_tpu_torch.models import zero_shot as tzs
from leaf_tpu_torch.models.preprocess import image_transform, read_image
from leaf_tpu_torch.train import fare as tfare
from leaf_tpu_torch.train import fare_driver as tdriver

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
EPS = 8 / 255


def _module(params):
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return module.eval()


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the JAX config, the port's CLIP module, images [2, 64,
    64, 3], a unit-column classifier [D, 5], targets [2])."""
    cfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    images = rng.uniform(0.2, 0.8, (2, 64, 64, 3)).astype(np.float32)
    clf = rng.standard_normal((cfg.embed_dim, 5)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0)
    return params, cfg, _module(params), images, clf, np.array([1, 3])


def _visual_sd(visual_params):
    return tinterop.params_from_jax(
        {"visual": jax.tree.map(np.asarray, visual_params)})


def _assert_visual_equal(visual, visual_params, atol, steps=1, lr=1e-4):
    """Every parameter within `atol`, but the attention's key bias within
    2 lr a step: its true gradient is zero (softmax is shift invariant), and
    Adam turns each framework's rounding noise there into a step of up to
    lr either way (ROADMAP Queue 3)."""
    want = _visual_sd(visual_params)
    got = {f"visual.{k}": v for k, v in visual.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if k.endswith("attn.qkv_b"):
            d = g.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], w[d:2 * d],
                                       atol=2 * steps * lr,
                                       err_msg=k)
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the vision tower's precision and remat
# ---------------------------------------------------------------------------

def test_gelu_is_the_jax_activation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(tlayers.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.gelu(jnp.asarray(x))),
                               atol=1e-6)


def test_vision_compute_dtype_and_remat(pair):
    """bf16 compute on fp32 weights: the JAX package's bf16 features, fp32
    gradients; `remat` changes neither values nor gradients."""
    params, cfg, module, images, _, _ = pair
    visual = _module(params).visual
    x = torch.from_numpy(images)
    want = np.asarray(jfare.encode_vision(params["visual"], cfg,
                                          jnp.asarray(images), False,
                                          jnp.bfloat16)).astype(np.float32)
    grads = []
    for remat in (False, True):
        visual.zero_grad(set_to_none=True)
        visual.compute_dtype = torch.bfloat16
        out = tfare.encode_vision(visual, module.cfg, x, False, remat=remat)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().detach().numpy(), want,
                                   atol=2e-2, rtol=2e-2)
        out.float().square().sum().backward()
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in visual.parameters())
        grads.append([p.grad.clone() for p in visual.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    visual.compute_dtype = None
    assert visual.dtype == torch.float32


# ---------------------------------------------------------------------------
# losses, optimizer, attack, step, loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_str", ["l2", "l1", "ce", "ce_reg"])
def test_embedding_loss_matches_jax(loss_str):
    rng = np.random.default_rng(1)
    emb, orig = (rng.standard_normal((4, 8)).astype(np.float32)
                 for _ in range(2))
    clf = rng.standard_normal((8, 6)).astype(np.float32)
    targets = np.array([0, 5, 2, 2])
    for reduction in ("mean", "none"):
        want = np.asarray(jfare.embedding_loss(
            loss_str, jnp.asarray(emb), jnp.asarray(orig),
            jnp.asarray(targets), jnp.asarray(clf), reduction=reduction))
        got = tfare.embedding_loss(
            loss_str, torch.from_numpy(emb), torch.from_numpy(orig),
            torch.from_numpy(targets), torch.from_numpy(clf),
            reduction=reduction).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt, grad_clip", [("adamw", False), ("sgd", False),
                                            ("adamw", True)])
def test_optimizer_matches_optax(opt, grad_clip):
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 4), "b": (4,), "s": (3,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    fcfg = tfare.FareConfig(steps=5, warmup=2, lr=1e-4, wd=0.1, opt=opt,
                            grad_clip=grad_clip)
    tx = jfare.make_fare_optimizer(jfare.FareConfig(**vars(fcfg)))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    topt = tfare.make_fare_optimizer(tp.values(), fcfg)
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.update(step)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        assert np.abs(np.asarray(jp[k]) - init[k]).max() > 1e-6


def _configs(**kw):
    fcfg = tfare.FareConfig(steps=4, warmup=1, lr=1e-4, eps=EPS,
                            iterations_adv=2, stepsize_adv=EPS / 2,
                            log_freq=1, **kw)
    return fcfg, jfare.FareConfig(**vars(fcfg))


@pytest.mark.parametrize("attack", ["pgd", "apgd"])
def test_attack_matches_jax(pair, attack):
    """PGD from the start JAX's key draws, handed to the port; APGD has
    none."""
    params, cfg, module, images, _, _ = pair
    fcfg, jcfg = _configs(attack=attack)
    orig = jfare.encode_vision(params["visual"], cfg,
                               jnp.asarray(np.roll(images, 1, axis=0)), False)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jfare.make_fare_attack(cfg, jcfg)(
        params["visual"], jnp.asarray(images), orig, jnp.zeros(2, jnp.int32),
        jnp.zeros((cfg.embed_dim, 1)), key))
    start = jcfg.eps * (2 * jax.random.uniform(key, images.shape) - 1)
    visual = _module(params).visual
    got = tfare.make_fare_attack(visual, module.cfg, fcfg)(
        torch.from_numpy(images), torch.from_numpy(np.array(orig)),
        torch.zeros(2, dtype=torch.long), None,
        delta=torch.from_numpy(np.array(start)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert np.abs(got.numpy() - images).max() <= EPS + 1e-6
    # the attack leaves the tower's weights requiring gradients
    assert all(p.requires_grad for p in visual.parameters())


@pytest.mark.parametrize("kw", [{}, {"loss": "ce", "clean_weight": 0.5,
                                     "loss_clean": "l1", "trades": True}])
def test_train_step_matches_jax(pair, kw):
    params, cfg, module, images, clf, targets = pair
    fcfg, jcfg = _configs(**kw)
    rng = np.random.default_rng(4)
    adv = np.clip(images + EPS * rng.choice([-1, 1], images.shape), 0, 1
                  ).astype(np.float32)
    orig = np.asarray(jfare.encode_vision(
        params["visual"], cfg, jnp.asarray(np.roll(images, 1, axis=0)),
        False))
    tx = jfare.make_fare_optimizer(jcfg)
    state = TrainState.create(jax.tree.map(jnp.copy, params["visual"]), tx)
    state, want = jfare.make_fare_train_step(cfg, jcfg, tx)(
        state, jnp.asarray(orig), jnp.asarray(images), jnp.asarray(adv),
        jnp.asarray(targets), jnp.asarray(clf))
    visual = _module(params).visual
    opt = tfare.make_fare_optimizer(visual.parameters(), fcfg)
    got = tfare.make_fare_train_step(visual, module.cfg, fcfg, opt)(
        0, torch.from_numpy(orig), torch.from_numpy(images),
        torch.from_numpy(adv), torch.from_numpy(targets),
        torch.from_numpy(clf))
    for k in ("loss", "loss_clean", "cos_sim"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _assert_visual_equal(visual, state.text_params, 1e-4)


def test_train_fare_matches_jax(pair):
    """2 steps of PGD, each from the start JAX's key schedule draws: the
    same per-step metrics, the same parameters, the text tower untouched,
    the frozen tower not trained."""
    params, cfg, module, images, _, _ = pair
    fcfg, jcfg = _configs()
    fcfg.steps = jcfg.steps = 2

    def batches():
        while True:
            yield images, None

    seen = {"jax": [], "torch": []}
    want = jfare.train_fare(params, cfg, jcfg, batches(), seed=5,
                            on_step=lambda s, m: seen["jax"].append((s, m)))
    key, starts = jax.random.PRNGKey(5), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        starts.append(torch.from_numpy(np.array(
            jcfg.eps * (2 * jax.random.uniform(sub, images.shape) - 1))))
    model = _module(params)
    text_before = {k: v.clone() for k, v in model.text.state_dict().items()}
    got = tfare.train_fare(model.visual, module.cfg, fcfg, batches(),
                           seed=5, starts=iter(starts),
                           on_step=lambda s, m: seen["torch"].append((s, m)))
    assert got["steps"] == 2 and [s for s, _ in seen["torch"]] == [1, 2]
    for (sj, mj), (st, mt) in zip(seen["jax"], seen["torch"]):
        assert sj == st
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    _assert_visual_equal(model.visual, want["params"]["visual"], 1e-4, 2)
    assert all(torch.equal(v, text_before[k])
               for k, v in model.text.state_dict().items())
    assert [sorted(t) for t in got["times"]] == [
        ["anchor_s", "attack_s", "step_s", "update_s", "wait_s"]] * 2


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(pair, tmp_path_factory):
    """An OpenCLIP checkpoint of the shared weights, and a PNG train folder
    of 4 images in 2 classes."""
    root = tmp_path_factory.mktemp("fare")
    module = pair[2]
    ckpt = str(root / "init")
    save_state_dict(params_to_openclip(module.state_dict(), module.cfg),
                    ckpt, "openclip")
    rng = np.random.default_rng(6)
    for i in range(4):
        d = root / "train" / f"c{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(d / f"{i}.png")
    return ckpt, str(root / "train")


def _record_steps(mp, module, seen):
    """Wrap a driver's `train_fare` to record each step's metrics."""
    inner = module.train_fare

    def recording(*args, **kw):
        kw["on_step"] = lambda s, m: seen.append((s, m["loss"]))
        return inner(*args, **kw)

    mp.setattr(module, "train_fare", recording)


def test_fare_driver_matches_jax(pair, files, tmp_path):
    """`--attack apgd`, 2 steps, then `--resume latest --steps 4`.  APGD has
    no random start: on the l2 loss it would start where the trainable and
    the frozen tower agree, at a zero gradient, so it maximises the
    cross-entropy against the 7-template classifier instead."""
    ckpt, train = files
    flags = ["--model", MODEL, "--pretrained", ckpt, "--imagenet-root", train,
             "--warmup", "1", "--batch-size", "2", "--eps", "8",
             "--iterations-adv", "2", "--attack", "apgd", "--inner-loss",
             "ce", "--template", "simple", "--lr", "1e-4", "--precision",
             "fp32", "--log-freq", "1"]
    seen = {"jax": [], "torch": []}
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        _record_steps(mp, jdriver, seen["jax"])
        _record_steps(mp, tfare, seen["torch"])
        for name, main, extra in (("jax", jdriver.main, []),
                                  ("torch", tdriver.main,
                                   ["--device", "cpu"])):
            out_dir = ["--output-dir", str(tmp_path / name)]
            main(flags + out_dir + extra + ["--steps", "2"])
            outs[name] = main(flags + out_dir + extra
                              + ["--steps", "4", "--resume", "latest"])
    assert [s for s, _ in seen["torch"]] == [1, 2, 3, 4]
    assert [s for s, _ in seen["jax"]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in seen["torch"]],
                               [v for _, v in seen["jax"]], rtol=1e-4)
    assert min(v for _, v in seen["torch"]) > 0
    _assert_visual_equal(outs["torch"]["visual"],
                         outs["jax"]["params"]["visual"], 1e-4, 4)
    assert outs["torch"]["state"].step == 4
    ck = tmp_path / "torch" / "FARE" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["epoch_1", "epoch_2", "epoch_3",
                                      "epoch_4"]


def test_fare_driver_command_line_on_cpu(files, tmp_path, monkeypatch):
    """PGD in bf16 with a fallback every step: the finished run leaves the
    milestones and no fallback; the resumed run restores the moments and
    the step; the flags whose code is missing, and CUDA where there is
    none, raise."""
    ckpt, train = files
    flags = ["--model", MODEL, "--imagenet-root", train, "--warmup", "1",
             "--batch-size", "2", "--iterations-adv", "1", "--precision",
             "bf16", "--fallback-freq", "1", "--output-dir", str(tmp_path)]
    out = tdriver.main(flags + ["--steps", "2", "--device", "cpu"])
    ck = tmp_path / "FARE" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["epoch_1", "epoch_2"]
    assert out["visual"].compute_dtype == torch.bfloat16
    saved = torch.load(ck / "epoch_2" / "state.pt", weights_only=True)
    assert saved["step"] == 2 and saved["opt_state"]["adamw"]["state"]
    out = tdriver.main(flags + ["--steps", "3", "--device", "cpu",
                                "--resume", "latest"])
    assert out["steps"] == 3 and len(out["times"]) == 1
    state = out["state"].optimizer.adamw.state_dict()["state"]
    assert all(float(s["step"]) == 3 for s in state.values())
    # ported since this case was written: without the wandb package the
    # tracker logs the JAX package's warning and the run trains untracked
    monkeypatch.setitem(sys.modules, "wandb", None)
    out = tdriver.main(flags + ["--steps", "1", "--device", "cpu",
                                "--report-to", "wandb", "--output-dir",
                                str(tmp_path / "tracked")])
    assert out["steps"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdriver.main(flags + ["--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tir.main(["--model", MODEL, "--imagenet-root", train,
                      "--output-dir", str(tmp_path / "ir")])
    with pytest.raises(ValueError, match="linf"):
        tir.main(["--model", MODEL, "--imagenet-root", train, "--square",
                  "--norm", "l2", "--device", "cpu"])


def test_ce_reg_gets_its_classifier(files, tmp_path):
    """The JAX driver builds the zero-shot classifier for `ce` alone and
    scores `--loss ce_reg` against a one-column zero classifier; the port
    builds it for `ce_reg` too, and its loss refuses to run without one."""
    _, train = files
    with pytest.raises(ValueError, match="classifier"):
        tfare.embedding_loss("ce_reg", torch.zeros(2, 4), torch.ones(2, 4),
                             torch.zeros(2, dtype=torch.long))
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _record_steps(mp, tfare, seen)
        out = tdriver.main(["--model", MODEL, "--imagenet-root", train,
                            "--steps", "1", "--warmup", "1", "--batch-size",
                            "2", "--iterations-adv", "1", "--loss", "ce_reg",
                            "--template", "simple", "--precision", "fp32",
                            "--output-dir", str(tmp_path), "--device",
                            "cpu"])
    assert out["steps"] == 1 and len(seen) == 1
    # 0.7 x the cross-entropy over 1,000 classes + 0.3 x the l2 drift
    assert np.isfinite(seen[0][1]) and seen[0][1] > 0.7 * np.log(2)


TEMPLATES = 2   # prompt templates of the classifier in the eval tests


@pytest.fixture(scope="module")
def val_folder(files, tmp_path_factory):
    """4 PNG images, each in the class folder (of 1,000) that the shared
    weights' zero-shot classifier picks for it, so that every clean
    prediction is right and the attacks have work to do."""
    from leaf_tpu_torch.attacks.engine import CandidateScorer
    from leaf_tpu_torch.benchmark.zeroshot_classification import _logits_fn
    from leaf_tpu_torch.models.factory import create_model, get_tokenizer
    ckpt, _ = files
    model = create_model(MODEL, ckpt, device="cpu", master_weights=True)
    scorer = CandidateScorer(model.cfg, "cpu")
    clf = tzs.build_zero_shot_classifier(
        lambda t: scorer.encode_text(model.module.text, t),
        get_tokenizer(MODEL), tzs.imagenet_classnames(),
        tzs.openai_imagenet_templates()[:TEMPLATES])
    root = tmp_path_factory.mktemp("val")
    rng = np.random.default_rng(7)
    pre = image_transform(64, do_normalize=False)
    for c in range(1000):
        (root / f"c{c:04d}").mkdir()
    for i in range(4):
        path = str(root / f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
                        ).save(path)
        x = torch.from_numpy(pre(read_image(path)))[None]
        with torch.no_grad():
            c = int(_logits_fn(model.module.visual, model.cfg, clf)(x)
                    .argmax())
        os.replace(path, root / f"c{c:04d}" / f"img{i}.png")
    return str(root)


def _writable_square():
    """The JAX search with writable margins (it assigns into them)."""
    inner = jsquare.square_attack

    def search(margin_loss_fn, *args, **kw):
        return inner(lambda x: tuple(np.array(a) for a in margin_loss_fn(x)),
                     *args, **kw)
    return search


@pytest.mark.parametrize("square", [False, True])
def test_imagenet_robust_matches_jax(files, val_folder, tmp_path, square):
    ckpt, _ = files
    flags = ["--model", MODEL, "--pretrained", ckpt, "--imagenet-root",
             val_folder, "--n-samples", "4", "--batch-size", "4", "--eps",
             "1", "--attack-iters", "2", "--n-targets", "1", "--save-adv"]
    if square:
        flags += ["--square", "--square-iters", "8"]
    results, seconds = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for zs in (jzs, tzs):
            templates = zs.openai_imagenet_templates()[:TEMPLATES]
            mp.setattr(zs, "openai_imagenet_templates", lambda t=templates: t)
        mp.setattr(jsquare, "square_attack", _writable_square())
        for name, main, extra in (("jax", jir.main, []),
                                  ("torch", tir.main, ["--device", "cpu"])):
            out = str(tmp_path / name)
            kw = {"seconds": seconds} if name == "torch" else {}
            main(flags + ["--output-dir", out] + extra, **kw)
            with open(os.path.join(out, "results.json")) as f:
                results[name] = json.load(f)
            results[name + "_adv"] = np.load(os.path.join(out, "x_adv.npy"))
    assert results["torch"] == results["jax"]
    assert results["torch"]["clean_acc1"] == 1.0
    np.testing.assert_allclose(results["torch_adv"], results["jax_adv"],
                               atol=1e-4)
    want = ["apgd", "classifier", "clean"] + (["square"] if square else [])
    assert sorted(seconds) == want
