"""leaf_tpu_torch's candidate scoring engine against the JAX package's,
in fp32 on the CPU.

The same JAX-initialised text tower goes through both scorers (the
port's copy by way of `interop.params_from_jax`), with token buffers,
anchors and masks made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.attacks import engine as jengine
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu_torch.attacks import engine as tengine
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=1e-5, rtol=1e-5)
EMBED = tconfig.get_model_config(MODEL).embed_dim


def _towers(seed: int):
    """(JAX text params, the port's text tower) holding the same weights."""
    params = jclip.init_clip(jax.random.PRNGKey(seed),
                             jconfig.get_model_config(MODEL))
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params["text"], module.text.eval()


@pytest.fixture(scope="module")
def pair():
    return _towers(0)


@pytest.fixture(scope="module")
def scorers():
    return (jengine.CandidateScorer(jconfig.get_model_config(MODEL), bucket=8),
            tengine.CandidateScorer(tconfig.get_model_config(MODEL), "cpu",
                                    bucket=8))


def _tokens(rng, shape, max_end):
    """Caption-like rows: SOT, random ids, EOT before `max_end`, zeros."""
    toks = np.zeros(shape, np.int32)
    flat = toks.reshape(-1, shape[-1])
    for row in flat:
        e = int(rng.integers(2, max_end))
        row[0] = 49406
        row[1:e] = rng.integers(1, 49400, size=e - 1)
        row[e] = 49407
    return toks


@pytest.mark.parametrize("objective", jengine.OBJECTIVES)
def test_objective_loss_matches_jax(objective):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 5, 8)).astype(np.float32)
    anchors = rng.standard_normal((3, 8)).astype(np.float32)
    want = jengine.objective_loss(jnp.asarray(feats), jnp.asarray(anchors),
                                  objective)
    got = tengine.objective_loss(torch.from_numpy(feats),
                                 torch.from_numpy(anchors), objective)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_objective_loss_rejects_unknown():
    with pytest.raises(ValueError, match="unknown objective"):
        tengine.objective_loss(torch.zeros(1, 2, 3), torch.zeros(1, 3), "l1")


def test_margin_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(4, 6))
    want = jengine.margin_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tengine.margin_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("objective", jengine.OBJECTIVES)
def test_score_rows_matches_jax(pair, scorers, objective):
    jtext, ttext = pair
    jscorer, tscorer = scorers
    rng = np.random.default_rng(2)
    B, N = 4, 6
    tokens = _tokens(rng, (B, N, 77), 14)
    anchors = rng.standard_normal((B, EMBED)).astype(np.float32)
    if objective in ("sim", "dissim"):
        anchors /= np.linalg.norm(anchors, axis=-1, keepdims=True)
    mask = rng.random((B, N)) < 0.7
    mask[:, 0] = True
    for m in (None, mask):
        jbest, jfeats, jloss = jscorer.score_rows(jtext, tokens, anchors,
                                                  objective, mask=m)
        tbest, tfeats, tloss = tscorer.score_rows(ttext, tokens, anchors,
                                                  objective, mask=m)
        assert isinstance(tbest, np.ndarray)
        np.testing.assert_array_equal(tbest, np.asarray(jbest))
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), **TOL)
        np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats), **TOL)
    # masked slots are -inf and never win
    assert np.isneginf(tloss.numpy()[~mask]).all()
    assert mask[np.arange(B), tbest].all()


def test_encode_text_buckets_and_matches_jax(pair, scorers):
    jtext, ttext = pair
    jscorer, tscorer = scorers
    tokens = _tokens(np.random.default_rng(3), (8, 77), 30)
    want = jscorer.encode_text(jtext, tokens, normalize=True)
    got = tscorer.encode_text(ttext, tokens, normalize=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # sliced to bucket 32: the features of the full buffer are the same
    with torch.no_grad():
        full = ttext.encode_text(torch.from_numpy(tokens), normalize=True)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("objective", ["l2", "negl2_normfeat", "l2_normfeat",
                                       "sim", "dissim"])
def test_score_flat_matches_jax(pair, scorers, objective):
    jtext, ttext = pair
    jscorer, tscorer = scorers
    rng = np.random.default_rng(4)
    tokens = _tokens(rng, (11, 77), 14)       # padded to 16 internally
    anchor = rng.standard_normal(EMBED).astype(np.float32)
    want = jscorer.score_flat(jtext, tokens, anchor, objective)
    got = tscorer.score_flat(ttext, tokens, anchor, objective)
    assert isinstance(got, np.ndarray) and got.shape == (11,)
    np.testing.assert_allclose(got, want, **TOL)


def test_score_flat_dual_encoder_mean_matches_jax(pair, scorers):
    jtext, ttext = pair
    jtext2, ttext2 = _towers(1)
    jscorer, tscorer = scorers
    rng = np.random.default_rng(5)
    tokens = _tokens(rng, (5, 77), 14)
    anchor, anchor2 = rng.standard_normal((2, EMBED)).astype(np.float32)
    want = jscorer.score_flat(jtext, tokens, anchor, "l2", anchor2=anchor2,
                              text_params2=jtext2)
    got = tscorer.score_flat(ttext, tokens, anchor, "l2", anchor2=anchor2,
                             text2=ttext2)
    np.testing.assert_allclose(got, want, **TOL)
    one = tscorer.score_flat(ttext, tokens, anchor, "l2")
    two = tscorer.score_flat(ttext2, tokens, anchor2, "l2")
    np.testing.assert_allclose(got, (one + two) / 2, **TOL)


def test_score_classification_matches_jax(pair, scorers):
    jtext, ttext = pair
    jscorer, tscorer = scorers
    rng = np.random.default_rng(6)
    class_feats = rng.standard_normal((4, EMBED)).astype(np.float32)
    class_feats /= np.linalg.norm(class_feats, axis=-1, keepdims=True)
    tokens = _tokens(rng, (7, 77), 14)
    jloss, jpreds = jscorer.score_classification(jtext, tokens, class_feats, 2)
    tloss, tpreds = tscorer.score_classification(ttext, tokens, class_feats, 2)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_array_equal(tpreds, jpreds)

    rows = _tokens(rng, (3, 5, 77), 14)
    labels = np.array([0, 3, 1])
    mask = np.ones((3, 5), bool)
    mask[1, 3:] = False
    jloss, jpreds = jscorer.score_classification_rows(jtext, rows, class_feats,
                                                      labels, mask)
    tloss, tpreds = tscorer.score_classification_rows(ttext, rows, class_feats,
                                                      labels, mask)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    np.testing.assert_array_equal(tpreds, jpreds)
    assert np.isneginf(tloss[~mask]).all()
