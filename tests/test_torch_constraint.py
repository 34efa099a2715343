"""leaf_tpu_torch's word-validity constraint against the JAX package's.

The port's word pattern runs on the standard library's `re` (Unicode
letter, number and white-space classes spelled out), the JAX package's
on `regex`: the tokens, counts and validity masks must be identical, on
the native path and on the Python one.
"""
import random
import string

import numpy as np
import pytest

from leaf_tpu.attacks import constraint as jconstraint
from leaf_tpu.attacks import edits as jedits
from leaf_tpu_torch.attacks import constraint as tconstraint
from leaf_tpu_torch.attacks import edits as tedits

WORDS = frozenset({"a", "photo", "of", "cat", "dog", "the", "train", "leaves",
                   "at", "it", "is", "do", "not", "we", "are", "he", "will",
                   "cafe", "naive", "red", "re", "s", "t", "ll", "in", "on"})
SENTENCES = [
    "a photo of a cat", "The train leaves at 9:15!", "it's a dog, isn't it?",
    "we're here; he'll go -- they've gone", "don't DO that... I'M not",
    "café naïve Ünïcödé straße", "x² + ½ = ③ (numbers ٣ and 四)",
    "tabs\tand\nnewlines\x0band\x1cseparators here nbsp",
    "under_score snake_case __init__", "'quoted' 'tis rock'n'roll o'clock",
    "emoji 🙂 and symbols © ™ € $5.00", "", " ", "a", "'", "''s", "5's 5'S",
    "ͅ combining ́ marks", "MiXeD CaSe WoRdS At ThE cAt",
]


def _jax_constraint(words):
    """The JAX package's constraint.  For an explicit word set it is held
    to its Python recount: its native binding would write the word list
    into the JAX package's source directory."""
    wc = jconstraint.WordConstraint(words)
    if words is not None:
        wc._native, wc._native_checked = None, True
    return wc


def battery():
    """The fixed sentences plus seeded random strings over letters, digits,
    punctuation, white space and a few non-ASCII characters."""
    rng = random.Random(0)
    alphabet = (string.ascii_letters + string.digits + string.punctuation
                + "   \t\n" + "éßñ½²四٣  '")
    out = list(SENTENCES)
    for _ in range(300):
        out.append("".join(rng.choice(alphabet)
                           for _ in range(rng.randrange(0, 40))))
    return out


def test_word_tokenize_matches_jax():
    for text in battery():
        assert tconstraint.word_tokenize(text) == \
            jconstraint.word_tokenize(text), repr(text)
        low = text.lower()
        assert tconstraint.word_tokenize(low) == \
            jconstraint.word_tokenize(low), repr(low)


def test_bpe_words_match_jax():
    ours, theirs = tconstraint._bpe_words(), jconstraint._bpe_words()
    assert ours == theirs and len(ours) > 10_000
    assert tconstraint._nltk_words() == jconstraint._nltk_words()
    # the default constraint picks the same lexicon in both packages
    assert tconstraint.WordConstraint().words == \
        jconstraint.WordConstraint().words


@pytest.mark.parametrize("words", [WORDS, None], ids=["explicit", "bpe"])
def test_count_valid_and_filter_match_jax(words):
    wc_t = tconstraint.WordConstraint(words)
    wc_j = _jax_constraint(words)
    rng = random.Random(1)
    sentences = battery()[:120]
    for S in sentences:
        assert wc_t.count(S) == wc_j.count(S), repr(S)
    originals = [s for s in sentences if s][:40]
    attacked = [[tedits.apply_edit(S, rng.randrange(2 * len(S) + 1),
                                   rng.randrange(len(tedits.DEFAULT_VOCAB)),
                                   tedits.DEFAULT_VOCAB, alternative=-1)
                 for _ in range(6)] for S in originals]
    for S, cands in zip(originals, attacked):
        assert wc_t.valid(S, cands) == wc_j.valid(S, cands)
        assert wc_t.valid(S, cands[0]) == wc_j.valid(S, cands[0])
        assert wc_t.filter(S, cands) == wc_j.filter(S, cands)
    got = wc_t.filter_batched(originals, attacked)
    assert got == wc_j.filter_batched(originals, attacked)
    # an invalid candidate is replaced by the original, a valid one kept
    flat = [(S, c, g) for S, cs, gs in zip(originals, attacked, got)
            for c, g in zip(cs, gs)]
    assert any(g == S and c != S for S, c, g in flat)
    assert any(g == c and c != S for S, c, g in flat)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("words", [WORDS, None], ids=["explicit", "bpe"])
def test_valid_edits_batch_matches_jax(words, native, monkeypatch):
    """[B, rho] (slot, codepoint) grids: the port's masks (C++ or the
    Python recount) equal the JAX package's and `valid` on the edited
    strings."""
    if not native:
        monkeypatch.setenv("LEAF_TPU_NO_NATIVE_TOKENIZER", "1")
    wc_t = tconstraint.WordConstraint(words)
    wc_j = _jax_constraint(words)
    assert (wc_t._get_native() is not None) == native
    rng = np.random.default_rng(2)
    ascii_s = ["a photo of a cat", "The train leaves at 9:15!",
               "it's a dog, isn't it?", "we are not in the red", "x", "do",
               "he'll do it"]
    mixed = ascii_s[:3] + ["café naïve at the cat"]
    vocab = np.asarray(tedits.DEFAULT_VOCAB, np.int32)
    for sentences in (ascii_s, mixed):
        B, rho = len(sentences), 24
        zs = np.stack([rng.integers(0, 2 * len(S) + 1, size=rho)
                       for S in sentences]).astype(np.int32)
        cps = vocab[rng.integers(0, len(vocab), size=(B, rho))]
        cps[:, 0] = ord(" ")
        cps[:, 1] = -1                                   # deletions
        got = np.asarray(wc_t.valid_edits_batch(sentences, zs, cps))
        want = np.asarray(wc_j.valid_edits_batch(sentences, zs, cps))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == bool and got.shape == (B, rho)
        for i, S in enumerate(sentences):
            edited = [jedits.apply_edit(S, int(z), 0, [int(c)], alternative=-1)
                      for z, c in zip(zs[i], cps[i])]
            assert list(got[i]) == wc_t.valid(S, edited)
        if words is WORDS:
            assert got.any() and not got.all()
