"""leaf_tpu_torch's image attacks for the robust eval (APGD, its losses,
the AutoAttack-style cascade, Square) against the JAX package's, in fp32
on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's copy
by way of `interop.params_from_jax`), with the same images from numpy.
Held: `l1_projection` and `_check_oscillation` equal; `apgd` in L-inf, L2
and L1 (train-mode top-k) the JAX package's adversarial images to 1e-5;
the CE and DLR losses to 1e-5; `_apgd_attack_batch` the same fooled masks
and images; `square_attack` the same images for the same seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.attacks import apgd as japgd
from leaf_tpu.attacks import square as jsquare
from leaf_tpu.benchmark import zeroshot_classification as jzsc
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.train import fare as jfare
from leaf_tpu_torch.attacks import apgd as tapgd
from leaf_tpu_torch.attacks import square as tsquare
from leaf_tpu_torch.benchmark import zeroshot_classification as tzsc
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.train import fare as tfare

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"


@pytest.fixture(scope="module")
def tower():
    """(JAX params, the port's frozen vision tower, the two packages'
    configs, images [3, 64, 64, 3], a unit-column classifier [D, 10], the
    images' clean classes)."""
    cfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), cfg)
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    module.eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    images = rng.uniform(0.2, 0.8, (3, 64, 64, 3)).astype(np.float32)
    clf = rng.standard_normal((cfg.embed_dim, 10)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0)
    logits = np.asarray(jzsc._logits_jit(params, cfg, jnp.asarray(clf),
                                         jnp.asarray(images)))
    return (params, module.visual, (cfg, module.cfg), images, clf,
            logits.argmax(-1))


def test_l1_projection_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (4, 3, 8, 8)).astype(np.float32)
    y = (0.3 * rng.standard_normal((4, 3, 8, 8))).astype(np.float32)
    for eps in (1.0, 5.0, 1e3):      # 1e3: inside the ball, the box alone
        want = np.asarray(japgd.l1_projection(jnp.asarray(x), jnp.asarray(y),
                                              eps))
        got = tapgd.l1_projection(torch.from_numpy(x), torch.from_numpy(y),
                                  eps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (np.abs(got + y).reshape(4, -1).sum(-1) <= eps + 1e-3).all()


def test_check_oscillation_matches_jax():
    rng = np.random.default_rng(2)
    n_iter = 12
    # integer losses: ties, where "improved" must read as not improved
    steps = rng.integers(0, 4, (n_iter, 5)).astype(np.float32)
    for j in (0, 3, 7, 11):
        for k in (1, 3, 6):
            want = np.asarray(japgd._check_oscillation(
                jnp.asarray(steps), j, k, n_iter))
            got = tapgd._check_oscillation(torch.from_numpy(steps), j, k,
                                           n_iter).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm, eps, is_train", [
    ("linf", 8 / 255, False), ("l2", 0.5, False), ("l1", 6.0, True)])
def test_apgd_matches_jax(tower, norm, eps, is_train):
    """20 iterations: checkpoints at shrinking intervals (L-inf, L2) or
    every iteration (L1), halvings and restarts from the best point."""
    params, visual, (cfg, tcfg), images, _, _ = tower
    # anchors of other images, so that the loss has a gradient at x
    anchors_np = np.asarray(jfare.encode_vision(
        params["visual"], cfg, jnp.asarray(np.roll(images, 1, axis=0)), False))

    def jloss(x):
        emb = jfare.encode_vision(params["visual"], cfg, x, False)
        return jnp.square(emb - anchors_np).sum(-1)

    want = np.asarray(jax.jit(lambda im: japgd.apgd(
        jloss, im, norm=norm, eps=eps, n_iter=20, is_train=is_train))(
            jnp.asarray(images)))
    anchors = torch.from_numpy(anchors_np.copy())

    def tloss(x):
        return (tfare.encode_vision(visual, tcfg, x, False) - anchors
                ).square().sum(-1)

    got = tapgd.apgd(tloss, torch.from_numpy(images), norm=norm, eps=eps,
                     n_iter=20, is_train=is_train).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - images).max() > 0


def test_classification_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((6, 7))).astype(np.float32)
    y = rng.integers(0, 7, 6)
    t = (y + 1 + rng.integers(0, 6, 6)) % 7
    cases = [(japgd.ce_loss_fn(lambda x: jnp.asarray(logits), jnp.asarray(y)),
              tapgd.ce_loss_fn(lambda x: torch.from_numpy(logits),
                               torch.from_numpy(y))),
             (japgd.dlr_targeted_loss_fn(lambda x: jnp.asarray(logits),
                                         jnp.asarray(y), jnp.asarray(t)),
              tapgd.dlr_targeted_loss_fn(lambda x: torch.from_numpy(logits),
                                         torch.from_numpy(y),
                                         torch.from_numpy(t)))]
    for jf, tf in cases:
        want = np.asarray(jf(jnp.zeros((6, 1))))
        got = tf(torch.zeros(6, 1)).numpy()
        assert got.shape == (6,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_apgd_attack_batch_matches_jax(tower):
    """The cascade at the eval's L-inf preset against labels the clean
    images get right: the same images fooled, the same points kept."""
    params, visual, (cfg, tcfg), images, clf, labels = tower
    eps = 4 / 255
    want_adv, want_fooled = jzsc._apgd_attack_batch(
        params, cfg, jnp.asarray(clf), jnp.asarray(images),
        jnp.asarray(labels), eps, n_iter=6, n_targets=2)
    got_adv, got_fooled = tzsc._apgd_attack_batch(
        visual, tcfg, torch.from_numpy(clf), torch.from_numpy(images),
        torch.from_numpy(labels), eps, n_iter=6, n_targets=2)
    np.testing.assert_array_equal(got_fooled.numpy(), np.asarray(want_fooled))
    np.testing.assert_allclose(got_adv.numpy(), np.asarray(want_adv),
                               atol=1e-5)
    assert got_fooled.any()


def test_square_attack_matches_jax(tower):
    params, visual, (cfg, tcfg), images, clf, labels = tower

    def jlogits(x):
        feats = jfare.encode_vision(params["visual"], cfg, x, True)
        return 100.0 * feats @ jnp.asarray(clf)

    def tlogits(x):
        feats = tfare.encode_vision(visual, tcfg, x, True)
        return 100.0 * feats @ torch.from_numpy(clf)

    jm = jsquare.make_margin_loss_fn(jlogits, labels)
    tm = tsquare.make_margin_loss_fn(tlogits, labels)
    loss_j, fooled_j = (np.asarray(a) for a in jm(jnp.asarray(images)))
    loss_t, fooled_t = (a.numpy() for a in tm(images))
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fooled_t, fooled_j)
    # the JAX search assigns into `np.asarray` of its margin function's
    # jax arrays, which are read-only: it is handed writable copies
    want = jsquare.square_attack(
        lambda x: tuple(np.array(a) for a in jm(x)), images, eps=8 / 255,
        n_iters=15, seed=0)
    got = tsquare.square_attack(tm, images, eps=8 / 255, n_iters=15, seed=0)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - images).max() <= 8 / 255 + 1e-6
    assert tsquare._p_selection(0.8, 30, 1000) == jsquare._p_selection(
        0.8, 30, 1000) == 0.1


def test_square_attack_takes_read_only_margins():
    """The JAX package's search fails at its first improvement when the
    margin function returns read-only arrays (a jitted function's, through
    `np.asarray`); the port's copies them."""
    images = np.full((2, 8, 8, 3), 0.5, np.float32)

    def margin(x):
        loss = np.asarray(x, np.float64).reshape(2, -1).sum(-1)
        loss.flags.writeable = False
        fooled = np.zeros(2, bool)
        fooled.flags.writeable = False
        return loss, fooled

    with pytest.raises(ValueError, match="read-only"):
        jsquare.square_attack(margin, images, eps=0.1, n_iters=5, seed=0)
    adv = tsquare.square_attack(margin, images, eps=0.1, n_iters=5, seed=0)
    assert adv.sum() > images.sum()
