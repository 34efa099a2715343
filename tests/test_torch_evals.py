"""leaf_tpu_torch's in-training evals against the JAX package's, in fp32
on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's copy
by way of `interop.params_from_jax`), with the same images, sentences and
class anchors.  Held: the zero-shot classifier to the fp32 feature
tolerance of `tests/test_torch_clip.py`; PGD from the same start to 1e-6
on all but 1% of pixels, inside the eps-ball; the Charmer classification
attack's sentences (native grids and string path) and every accuracy
exactly; `zero_shot_eval`'s dict exactly but for the PGD top-1, whose
start comes from another generator; and one `driver.main` of each
package on the same tar set and image folder: the same adversarial
training sentences and `results.csv` rows.

The ImageNet classifier is built from 12 of the 1000 class names and 4 of
the 80 templates (the `subset` fixture): the same code path at a size the CPU tests
can afford.
"""
import csv
import io
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from leaf_tpu import data as jdata
from leaf_tpu.attacks import image as jimage
from leaf_tpu.attacks import text as jtext
from leaf_tpu.attacks.engine import CandidateScorer as JScorer
from leaf_tpu.evals import zero_shot as jzs
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.models import preprocess as jpre
from leaf_tpu.models import zero_shot as jzsm
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu.train import driver as jdriver
from leaf_tpu.train import fused as jfused
from leaf_tpu.train import params as jparams
from leaf_tpu_torch import data as tdata
from leaf_tpu_torch.attacks import image as timage
from leaf_tpu_torch.attacks import text as ttext
from leaf_tpu_torch.attacks.engine import CandidateScorer as TScorer
from leaf_tpu_torch.convert import params_to_openclip, save_state_dict
from leaf_tpu_torch.evals import zero_shot as tzs
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.models import preprocess as tpre
from leaf_tpu_torch.models import zero_shot as tzsm
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer
from leaf_tpu_torch.train import driver as tdriver
from leaf_tpu_torch.train import fused as tfused
from leaf_tpu_torch.train import params as tparams

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=1e-5, rtol=1e-4)     # fp32 features, tests/test_torch_clip.py
EPS = 2 / 255
SENTENCES = ["stocks rally on strong earnings", "the team won the cup",
             "new chip unveiled today", "ancient fossil found in a cave",
             "a terrible film review", "great policy for the market"]


@pytest.fixture(scope="module")
def subset():
    """Both packages' evals see 12 class names and 4 templates."""
    names = jzsm.imagenet_classnames()[::83][:12]
    templates = jzsm.openai_imagenet_templates()[:4]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jzs, tzs):
            mp.setattr(mod, "imagenet_classnames", lambda: list(names))
            mp.setattr(mod, "openai_imagenet_templates",
                       lambda: list(templates))
        yield names, templates


@pytest.fixture(scope="module")
def pair():
    """JAX config and params, and the port's CLIP module with the same
    weights (fp32, CPU, the vision tower frozen as the driver keeps it)."""
    jcfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    module.eval().visual.requires_grad_(False)
    return jcfg, params, module


@pytest.fixture(scope="module")
def scorers(pair):
    return JScorer(pair[0]), TScorer(pair[2].cfg, "cpu")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """An ImageNet-style folder: 4 classes x 2 PNGs of 64 x 80 pixels,
    and three tar shards of 8 captions each."""
    root = tmp_path_factory.mktemp("evals")
    rng = np.random.default_rng(7)
    for c in range(4):
        os.makedirs(root / "imagenet" / f"c{c}")
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
                            ).save(root / "imagenet" / f"c{c}" / f"{i}.png")
    words = "a photo of the small red dog cat man on a street".split()
    os.makedirs(root / "tars")
    for s in range(3):
        with tarfile.open(root / "tars" / f"{s:03d}.tar", "w") as tf:
            for i in range(8):
                cap = " ".join(rng.choice(words, size=int(
                    rng.integers(3, 9)))).encode()
                info = tarfile.TarInfo(f"{s}_{i:03d}.txt")
                info.size = len(cap)
                tf.addfile(info, io.BytesIO(cap))
    return str(root)


def _classifiers(pair, scorers, subset):
    """Both packages' classifiers over `subset`, 10 classes a call as the
    eval builds them."""
    jcfg, params, module = pair
    names, templates = subset
    jc = jzsm.build_zero_shot_classifier(
        lambda t: scorers[0].encode_text(params["text"], t), jax_tokenizer(),
        names, templates, num_classes_per_batch=10)
    tc = tzsm.build_zero_shot_classifier(
        lambda t: scorers[1].encode_text(module.text, t), port_tokenizer(),
        names, templates, num_classes_per_batch=10)
    return np.asarray(jc), tc


def test_zero_shot_metadata_is_the_jax_packages():
    assert tzsm.imagenet_classnames() == jzsm.imagenet_classnames()
    assert tzsm.openai_imagenet_templates() == jzsm.openai_imagenet_templates()
    assert tzsm.simple_imagenet_templates() == jzsm.simple_imagenet_templates()


def test_build_zero_shot_classifier_matches_jax(pair, scorers, subset):
    jc, tc = _classifiers(pair, scorers, subset)
    assert tc.dtype == torch.float32 and tc.shape == jc.shape == (64, 12)
    np.testing.assert_allclose(tc.numpy(), jc, **TOL)
    np.testing.assert_allclose(np.linalg.norm(tc.numpy(), axis=0), 1.0,
                               rtol=1e-5)


def _images(n=3, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 64, 64, 3)).astype(np.float32)


def _start(key, shape):
    """The JAX attacks' uniform start for `key`, as they draw it."""
    return np.array(EPS * (2 * jax.random.uniform(key, shape, jnp.float32)
                            - 1))


def _hold_pgd(got, want, clean):
    """At most 1% of elements differ by more than 1e-6; every element
    stays within eps of the clean image."""
    got = got.detach().numpy()
    assert float(np.mean(np.abs(got - want) > 1e-6)) <= 0.01
    assert float(np.abs(got - clean).max()) <= EPS + 1e-6
    assert float(np.abs(want - clean).max()) <= EPS + 1e-6


def test_attack_image_classification_matches_jax(pair, scorers, subset):
    jcfg, params, module = pair
    jc, tc = _classifiers(pair, scorers, subset)
    images, labels = _images(), np.asarray([0, 5, 11])
    key = jax.random.PRNGKey(3)
    want = np.asarray(jimage.attack_image_classification(
        params, jcfg, jnp.asarray(images), jnp.asarray(jc),
        jnp.asarray(labels), key, n_steps=3))
    got = timage.attack_image_classification(
        module.visual, module.cfg, torch.from_numpy(images), tc,
        torch.from_numpy(labels), n_steps=3,
        delta=torch.from_numpy(_start(key, images.shape)))
    _hold_pgd(got, want, images)
    # the port's own start comes from a torch.Generator, inside the ball
    own = timage.attack_image_classification(
        module.visual, module.cfg, torch.from_numpy(images), tc,
        torch.from_numpy(labels), torch.Generator().manual_seed(0), n_steps=1)
    assert float((own - torch.from_numpy(images)).abs().max()) <= EPS + 1e-6


@pytest.mark.parametrize("objective", ["l2", "dissim"])
def test_attack_image_matches_jax(pair, objective):
    jcfg, params, module = pair
    images = _images(2, seed=1)
    anchors = np.random.default_rng(2).standard_normal((2, 64)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jimage.attack_image(
        params, jcfg, jnp.asarray(images), jnp.asarray(anchors), key,
        objective=objective, n_steps=2))
    got = timage.attack_image(
        module.visual, module.cfg, torch.from_numpy(images),
        torch.from_numpy(anchors), objective=objective, n_steps=2,
        delta=torch.from_numpy(_start(key, images.shape)))
    _hold_pgd(got, want, images)


@pytest.mark.parametrize("norm", ["linf", "l2"])
def test_momentum_pgd_matches_jax(pair, norm):
    jcfg, params, module = pair
    images = _images(2, seed=2)
    anchors = np.random.default_rng(3).standard_normal((2, 64)).astype(
        np.float32)
    eps, step = (EPS, EPS / 4) if norm == "linf" else (0.5, 0.1)

    def jloss(x):
        f = jclip.encode_image_model(params, jcfg,
                                     jimage._normalize_images(x, jcfg))
        return jnp.sum(jnp.square(f - anchors))

    def tloss(x):
        f = module.visual.encode_image(timage._normalize_images(x))
        return (f - torch.from_numpy(anchors)).square().sum()

    want = np.asarray(jimage.pgd(jloss, jnp.asarray(images), norm, eps, 2,
                                 step))
    got = timage.pgd(tloss, torch.from_numpy(images), norm, eps, 2, step)
    assert float(np.mean(np.abs(got.numpy() - want) > 1e-6)) <= 0.01
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def _class_features(n_classes=4, seed=5):
    f = np.random.default_rng(seed).standard_normal((n_classes, 64))
    return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("path", ["native", "string"])
def test_charmer_classification_matches_jax(pair, scorers, path):
    """The batched attack and the per-sentence one pick the JAX package's
    sentences; an accented sentence sends a batch to the string path."""
    _, params, module = pair
    sentences = list(SENTENCES)
    if path == "string":
        sentences[2] = "new chip unveiled in Zürich"
    vocab = sorted(set(jdata.char_vocabulary(SENTENCES)))[:12]
    feats, labels = _class_features(), [0, 1, 2, 3, 1, 0]
    jtok, ttok = jax_tokenizer(), port_tokenizer()
    assert ttext._fused_ok(ttext._native_of(ttok), None, sentences,
                           vocab) == (path == "native")
    want = jtext.attack_text_charmer_classification_batched(
        scorers[0], params["text"], jtok, sentences, feats, labels, n=3, k=2,
        vocab=vocab)
    got = ttext.attack_text_charmer_classification_batched(
        scorers[1], module.text, ttok, sentences, feats, labels, n=3, k=2,
        vocab=vocab)
    assert got == want
    assert got != sentences
    one = [jtext.attack_text_charmer_classification(
        scorers[0], params["text"], jtok, sentences[i], feats, labels[i],
        n=3, k=2, vocab=vocab) for i in (0, 2)]
    assert [ttext.attack_text_charmer_classification(
        scorers[1], module.text, ttok, sentences[i], feats, labels[i],
        n=3, k=2, vocab=vocab) for i in (0, 2)] == one


def _textcls(pkg):
    """AG-News metadata over the synthetic eval sentences (the eval's own
    inputs and chunk shapes, so the JAX side reuses its compiles)."""
    from leaf_tpu.evals.textfare import _load_eval_samples
    samples, _ = _load_eval_samples("synthetic", 8)
    samples = [dict(s, label=i % 4) for i, s in enumerate(samples)]
    return pkg.TextClassificationData.from_samples("agnews", samples)


def test_run_text_classification_matches_jax(pair, scorers):
    jcfg, params, module = pair
    pre_j = jpre.image_transform(64, do_normalize=False)
    pre_t = tpre.image_transform(64, do_normalize=False)
    ja = np.asarray(jzs.encode_anchor_images(params, jcfg, _textcls(jdata),
                                             pre_j))
    ta = tzs.encode_anchor_images(module.visual, module.cfg, _textcls(tdata),
                                  pre_t)
    np.testing.assert_allclose(ta.numpy(), ja, **TOL)
    want = jzs.run_text_classification(
        scorers[0], params, jax_tokenizer(), ja, _textcls(jdata),
        n_charmer=3, k=1)
    got = tzs.run_text_classification(
        scorers[1], module.text, port_tokenizer(), ta, _textcls(tdata),
        n_charmer=3, k=1)
    assert got == want


def _eval_flags(folder):
    return ["--model", MODEL, "--dataset-type", "synthetic",
            "--imagenet-val", os.path.join(folder, "imagenet"),
            "--n_val_imagenet", "8", "--batch-size", "4",
            "--val-text-classification", "synthetic", "--n_val_text", "8",
            "--n_charmer_test", "3", "--zeroshot-frequency", "1"]


def test_zero_shot_eval_matches_jax(pair, scorers, subset, folder):
    jcfg, params, module = pair
    jargs = jparams.parse_args(_eval_flags(folder))
    targs = tparams.parse_args(_eval_flags(folder))
    pre_j = jpre.image_transform(64, do_normalize=False)
    pre_t = tpre.image_transform(64, do_normalize=False)
    want = jzs.zero_shot_eval(params, jcfg, jdata.get_data(jargs, pre_j),
                              jax_tokenizer(), pre_j, 1, jargs,
                              scorer=scorers[0], key=jax.random.PRNGKey(1))
    seconds = {}
    got = tzs.zero_shot_eval(module, module.cfg, tdata.get_data(targs, pre_t),
                             port_tokenizer(), pre_t, 1, targs,
                             scorer=scorers[1],
                             generator=torch.Generator().manual_seed(1),
                             seconds=seconds)
    adv = "imagenet-zeroshot-val-top1-adv"
    assert sorted(got) == sorted(want) == sorted(tdriver.RESULT_COLUMNS[2:])
    assert 0.0 <= got.pop(adv) <= got["imagenet-zeroshot-val-top1"]
    want.pop(adv)
    assert got == want
    assert sorted(seconds) == ["classifier", "clean", "pgd",
                               "text_classification"]


# ---------------------------------------------------------------------------
# the slice as a whole: driver.main of both packages
# ---------------------------------------------------------------------------

def _record_adversaries(mp, cls, seen):
    """Wrap a FusedLeafStep's call to record each batch's adversarial
    sentences."""
    call = cls.__call__

    def recording(self, state, frozen, texts, rng, *a, **kw):
        state, info = call(self, state, frozen, texts, rng, *a, **kw)
        seen.append(self.adv_sentences(list(texts), info))
        return state, info

    mp.setattr(cls, "__call__", recording)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_driver_matches_jax(pair, subset, folder, tmp_path):
    """`--dataset-type webdataset`, `--imagenet-val`, `--val-text-
    classification synthetic`, `--zeroshot-frequency 1`: 1 epoch, 2 steps,
    rho 4, from one checkpoint of the shared weights."""
    module = pair[2]
    ckpt = str(tmp_path / "init")
    save_state_dict(params_to_openclip(module.state_dict(), module.cfg),
                    ckpt, "openclip")
    flags = (_eval_flags(folder)[:2]
             + ["--pretrained", ckpt, "--train-data",
                os.path.join(folder, "tars", "{000..002}.tar"),
                "--dataset-type", "webdataset", "--train-num-samples", "8",
                "--epochs", "1", "--rho", "4", "--warmup", "2", "--lr",
                "1e-4", "--log-every-n-steps", "1"] + _eval_flags(folder)[4:])
    seen = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        _record_adversaries(mp, jfused.FusedLeafStep, seen["jax"])
        _record_adversaries(mp, tfused.FusedLeafStep, seen["torch"])
        jdriver.main(jparams.parse_args(
            flags + ["--logs", str(tmp_path), "--name", "jax"]))
        out = tdriver.main(flags + ["--device", "cpu", "--logs",
                                    str(tmp_path), "--name", "torch"])
    assert len(seen["torch"]) == 2 and seen["torch"] == seen["jax"]
    want = _rows(tmp_path / "jax" / "results.csv")
    got = _rows(tmp_path / "torch" / "results.csv")
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == ["0", "1"]
    adv = "imagenet-zeroshot-val-top1-adv"
    for g, w in zip(got, want):
        assert 0.0 <= float(g[adv]) <= float(g["imagenet-zeroshot-val-top1"])
        np.testing.assert_allclose(float(g.pop("train_loss")),
                                   float(w.pop("train_loss")), rtol=1e-5)
        g.pop(adv)
        w.pop(adv)
        assert g == w
    assert sorted(out["eval_seconds"]) == [0, 1]
