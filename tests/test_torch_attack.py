"""leaf_tpu_torch's sentence edits and LEAF training attack against the
JAX package's, in fp32 on the CPU.

The same JAX-initialised text tower goes through both attacks (the
port's copy by way of `interop.params_from_jax`), each with its own
package's tokenizer and a `np.random.default_rng` of the same seed: the
adversarial sentences must be identical.
"""
import string

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from leaf_tpu.attacks import edits as jedits
from leaf_tpu.attacks import engine as jengine
from leaf_tpu.attacks import text as jtext_attacks
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.tokenizer import get_tokenizer as get_jax_tokenizer
from leaf_tpu_torch.attacks import edits as tedits
from leaf_tpu_torch.attacks import engine as tengine
from leaf_tpu_torch.attacks import text as ttext_attacks
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.tokenizer import get_tokenizer as get_torch_tokenizer

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
SENTENCES = ["a photo of a small red dog", "two cats sleep on the old sofa",
             "The train leaves at 9:15!", "snow", "green field near a river",
             "a man rides a horse"]


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return {
        "jtext": params["text"], "ttext": module.text.eval(),
        "jscorer": jengine.CandidateScorer(jcfg),
        "tscorer": tengine.CandidateScorer(tconfig.get_model_config(MODEL),
                                           "cpu"),
        "jtok": get_jax_tokenizer(), "ttok": get_torch_tokenizer(),
    }


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("objective", jengine.OBJECTIVES)
def test_attack_text_leaf_picks_the_same_sentences(setup, objective, k):
    s = setup
    anchors = np.asarray(s["jscorer"].encode_text(s["jtext"],
                                                  s["jtok"](SENTENCES)))
    jfeats, jadv = jtext_attacks.attack_text_leaf(
        s["jscorer"], s["jtext"], s["jtok"], SENTENCES, anchors,
        objective=objective, n=8, k=k, rng=np.random.default_rng(11))
    tfeats, tadv = ttext_attacks.attack_text_leaf(
        s["tscorer"], s["ttext"], s["ttok"], SENTENCES, anchors,
        objective=objective, n=8, k=k, rng=np.random.default_rng(11))
    assert tadv == jadv
    assert any(a != c for a, c in zip(tadv, SENTENCES))
    assert isinstance(tfeats, np.ndarray) and tfeats.dtype == np.float32
    np.testing.assert_allclose(tfeats, np.asarray(jfeats), atol=1e-5,
                               rtol=1e-5)


def test_attack_text_leaf_draws_like_jax_and_reports_its_seconds(setup):
    """After the attack both generators are in the same state, and the
    host/device split adds up to a positive time."""
    s = setup
    anchors = np.asarray(s["jscorer"].encode_text(s["jtext"],
                                                  s["jtok"](SENTENCES)))
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    jtext_attacks.attack_text_leaf(s["jscorer"], s["jtext"], s["jtok"],
                                   SENTENCES, anchors, n=60, rng=jrng)
    seconds = {}
    ttext_attacks.attack_text_leaf(s["tscorer"], s["ttext"], s["ttok"],
                                   SENTENCES, anchors, n=60, rng=trng,
                                   seconds=seconds)
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)
    assert seconds["host"] > 0 and seconds["device"] > 0


def test_attack_text_leaf_rejects_a_constraint(setup):
    """Under a word constraint the attack rejects the candidates the
    constraint rejects (they score as the clean sentence): the same
    sentences as the JAX package's constrained attack, every one of them
    either unchanged or valid."""
    from leaf_tpu.attacks.constraint import WordConstraint as JWordConstraint
    from leaf_tpu_torch.attacks.constraint import WordConstraint
    s = setup
    anchors = np.asarray(s["jscorer"].encode_text(s["jtext"],
                                                  s["jtok"](SENTENCES)))
    wc = WordConstraint()
    for k in (1, 2):
        _, jadv = jtext_attacks.attack_text_leaf(
            s["jscorer"], s["jtext"], s["jtok"], SENTENCES, anchors, n=8, k=k,
            constraint=JWordConstraint(), rng=np.random.default_rng(3))
        _, tadv = ttext_attacks.attack_text_leaf(
            s["tscorer"], s["ttext"], s["ttok"], SENTENCES, anchors, n=8, k=k,
            constraint=wc, rng=np.random.default_rng(3))
        assert tadv == jadv
        assert any(a != c for a, c in zip(tadv, SENTENCES))
        assert all(a == c or wc.count(a) < wc.count(c)
                   for a, c in zip(tadv, SENTENCES))


def test_pad_rows_matches_jax(setup):
    rows = [["a dog", "a cat", "a cow"], ["snow"], ["red", "blue"]]
    clean = ["a pet", "rain", "green"]
    jtok, jmask = jtext_attacks._pad_rows(setup["jtok"], clean, rows)
    ttok, tmask = ttext_attacks._pad_rows(setup["ttok"], clean, rows)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tmask, jmask)


# ---------------------------------------------------------------------------
# edits: the same function of (sentence, slot, character) and of the generator
# ---------------------------------------------------------------------------

def test_vocabularies_match_jax():
    assert tedits.DEFAULT_VOCAB == jedits.DEFAULT_VOCAB
    assert tedits.SPACE_VOCAB == jedits.SPACE_VOCAB
    assert len(tedits.DEFAULT_VOCAB) == 96


_TEXT = st.text(alphabet=string.ascii_letters + string.digits + " _.,!&",
                min_size=0, max_size=24)


@settings(max_examples=60, deadline=None)
@given(sentence=_TEXT, data=st.data())
def test_apply_edit_matches_jax(sentence, data):
    k = data.draw(st.integers(1, 2))
    assert tedits.num_slots(len(sentence), k) == \
        jedits.num_slots(len(sentence), k)
    z = data.draw(st.integers(0, tedits.num_slots(len(sentence), k) - 1))
    u = data.draw(st.integers(0, len(tedits.DEFAULT_VOCAB) - 1))
    alternative = data.draw(st.sampled_from([None, -1, ord("#")]))
    assert tedits.apply_edit(sentence, z, u, tedits.DEFAULT_VOCAB, k,
                             alternative) == \
        jedits.apply_edit(sentence, z, u, jedits.DEFAULT_VOCAB, k, alternative)
    if k == 1:
        assert tedits.generate_all_sentences_at_z(sentence, z) == \
            jedits.generate_all_sentences_at_z(sentence, z)


@settings(max_examples=40, deadline=None)
@given(length=st.integers(0, 40), n=st.integers(1, 90), seed=st.integers(0, 99))
def test_sample_positions_draws_like_jax(length, n, seed):
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    np.testing.assert_array_equal(
        tedits.sample_positions(length, n, rng=trng),
        jedits.sample_positions(length, n, rng=jrng))
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)


@settings(max_examples=20, deadline=None)
@given(sentence=_TEXT, n=st.integers(1, 12), seed=st.integers(0, 99),
       k=st.integers(1, 2))
def test_random_sentences_draw_like_jax(sentence, n, seed, k):
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    assert tedits.generate_random_sentences(
        sentence, tedits.DEFAULT_VOCAB, n, k=k, alternative=-1, rng=trng) == \
        jedits.generate_random_sentences(
            sentence, jedits.DEFAULT_VOCAB, n, k=k, alternative=-1, rng=jrng)
    assert tedits.generate_random_sentences_at_z(
        sentence, 0, tedits.DEFAULT_VOCAB, n, rng=trng) == \
        jedits.generate_random_sentences_at_z(
            sentence, 0, jedits.DEFAULT_VOCAB, n, rng=jrng)
