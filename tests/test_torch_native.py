"""leaf_tpu_torch's native C++ tokenizer (`tokenizer/native_binding.py`,
built at first use from the port's own copy of the source) against the
JAX package's binding and against the port's Python tokenizer.

Tokens must be equal exactly.  Also held: where the build writes, that a
failed build raises, and that `LEAF_TPU_NO_NATIVE_TOKENIZER` selects the
Python path.
"""
import os
import random
import string
import subprocess
import sys

import numpy as np
import pytest

from leaf_tpu.attacks import edits as jedits
from leaf_tpu.tokenizer.bpe import DEFAULT_BPE_PATH as JAX_BPE_PATH
from leaf_tpu.tokenizer.native_binding import get_native as jax_native
from leaf_tpu_torch.attacks import constraint as tconstraint
from leaf_tpu_torch.attacks import edits as tedits
from leaf_tpu_torch.attacks import text as ttext
from leaf_tpu_torch.tokenizer import bpe as tbpe
from leaf_tpu_torch.tokenizer import native_binding as nb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = [
    "a photo of a cat.", "A PHOTO OF A DOG!!!",
    "the quick brown fox jumps over the lazy dog",
    "Wall St. Bears Claw Back Into the Black (Reuters)",
    "it 's a lovely film with lovely performances",
    "numbers 1234567890 mixed42tokens",
    "punctuation!@#$%^*()_+-=[]{}|;':\",./<>?",
    "contractions don't can't we're i'll they've she'd i'm",
    "", "x", "supercalifragilisticexpialidocious",
    "   leading and trailing   whitespace   ",
    "apostrophe edge 'x 'll' ''s",
]
SENTENCES = ["a photo of a cat", "wall street stocks fall!", "x", "hi",
             "Hello World", "a  b", "trailing "]


@pytest.fixture(scope="module")
def native():
    return nb.get_native(tbpe.DEFAULT_BPE_PATH)


@pytest.fixture(scope="module")
def jnative():
    handle = jax_native(JAX_BPE_PATH)
    if handle is None:
        pytest.skip("the JAX package's native tokenizer is unavailable")
    return handle


@pytest.fixture(scope="module")
def py_tok():
    """The port's tokenizer held to its Python path."""
    tok = tbpe.CLIPTokenizer()
    tok._native, tok._native_checked = None, True
    return tok


def mutated_battery():
    rng = random.Random(0)
    vocab = (string.ascii_letters + " " + string.digits
             + string.punctuation).replace("&", "")
    out = []
    for base in TEXTS:
        for _ in range(10):
            s = base
            for _ in range(rng.randrange(1, 3)):
                if not s:
                    s = rng.choice(vocab)
                    continue
                i = rng.randrange(len(s))
                op = rng.randrange(3)
                if op == 0:
                    s = s[:i] + rng.choice(vocab) + s[i:]
                elif op == 1:
                    s = s[:i] + rng.choice(vocab) + s[i + 1:]
                else:
                    s = s[:i] + s[i + 1:]
            out.append(s)
    return out


def _grids(rng, sentences, rho):
    vocab = np.asarray(tedits.DEFAULT_VOCAB, np.int32)
    zs = np.stack([rng.integers(0, 2 * len(s) + 1, size=rho)
                   for s in sentences]).astype(np.int32)
    us = rng.integers(0, len(vocab), size=(len(sentences), rho))
    return zs, us, vocab[us]


def test_encode_batch_matches_jax_and_python(native, jnative, py_tok):
    texts = TEXTS + mutated_battery()
    for ctx in (77, 16):
        ours = native.encode_batch(texts, ctx)
        np.testing.assert_array_equal(ours, jnative.encode_batch(texts, ctx))
        np.testing.assert_array_equal(ours, py_tok(texts, ctx))
        assert ours.dtype == np.int32 and ours.shape == (len(texts), ctx)
    assert native.encode("hello world") == py_tok.encode("hello world")


def test_truncation_at_the_context_length(native, jnative, py_tok):
    long = "word " * 200
    out = native.encode_batch([long], 77)
    assert out[0, 0] == 49406 and out[0, -1] == 49407 and (out[0] != 0).all()
    np.testing.assert_array_equal(out, py_tok([long]))
    # an edit grid on a sentence longer than the context
    zs = np.asarray([[0, 7, 400, 2 * len(long)]], np.int32)
    cps = np.asarray([[ord("q"), -1, ord(" "), ord("z")]], np.int32)
    got = native.encode_edits([long], zs, cps, 77)
    np.testing.assert_array_equal(got, jnative.encode_edits([long], zs, cps, 77))
    assert (got[:, -1] == 49407).all()


def test_encode_edits_random_grids(native, jnative, py_tok):
    rng = np.random.default_rng(0)
    rho = 12
    zs, us, cps = _grids(rng, SENTENCES, rho)
    out = native.encode_edits(SENTENCES, zs, cps, 77)
    np.testing.assert_array_equal(
        out, jnative.encode_edits(SENTENCES, zs, cps, 77))
    out = out.reshape(len(SENTENCES), rho, 77)
    for i, s in enumerate(SENTENCES):
        expect = [tedits.apply_edit(s, int(zs[i, j]), int(us[i, j]),
                                    tedits.DEFAULT_VOCAB, alternative=-1)
                  for j in range(rho)]
        assert expect == [jedits.apply_edit(
            s, int(zs[i, j]), int(us[i, j]), jedits.DEFAULT_VOCAB,
            alternative=-1) for j in range(rho)]
        np.testing.assert_array_equal(out[i], py_tok(expect))


def test_encode_edits_exhaustive_slot_vocab(native, jnative, py_tok):
    """Every slot of one sentence x the whole attack vocabulary, plus the
    '_' slot placeholder (a self-substitution no-op under alternative=-1)
    and deletion (-1)."""
    s = "a photo of a cat"
    probe = list(tedits.DEFAULT_VOCAB) + [ord("_"), -1]
    n_slots = 2 * len(s) + 1
    zs = np.repeat(np.arange(n_slots, dtype=np.int32), len(probe))[None]
    cps = np.tile(np.asarray(probe, np.int32), n_slots)[None]
    out = native.encode_edits([s], zs, cps, 77)
    np.testing.assert_array_equal(out, jnative.encode_edits([s], zs, cps, 77))
    expect = [tedits.apply_edit(s, int(z), 0, [int(cp)], alternative=-1)
              for z, cp in zip(zs[0], cps[0])]
    np.testing.assert_array_equal(out, py_tok(expect))
    assert len(expect) == n_slots * len(probe) > 1000


def test_encode_edits_space_probes(native, jnative, py_tok):
    rng = np.random.default_rng(1)
    rho = 8
    zs = np.stack([np.asarray(tedits.sample_positions(len(s), rho, rng=rng))
                   for s in SENTENCES]).astype(np.int32)
    cps = np.full(zs.shape, ord(" "), np.int32)
    out = native.encode_edits(SENTENCES, zs, cps, 77)
    np.testing.assert_array_equal(
        out, jnative.encode_edits(SENTENCES, zs, cps, 77))
    expect = [tedits.apply_edit(s, int(z), 0, tedits.SPACE_VOCAB,
                                alternative=-1)
              for s, row in zip(SENTENCES, zs) for z in row]
    np.testing.assert_array_equal(out, py_tok(expect))


def test_edit_grids_are_validated(native):
    zs = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="edit grids"):
        native.encode_edits(["a"], zs, zs, 77)
    with pytest.raises(ValueError, match="edit grids"):
        native.encode_edits(["a", "b"], zs, zs[:, :2], 77)


def test_wc_valid_edits_equals_valid_on_edited_strings():
    wc = tconstraint.WordConstraint()
    checker = wc._get_native()
    assert isinstance(checker, nb.NativeWordDict)
    rng = np.random.default_rng(2)
    sentences = ["wall street stocks fall", "a photo of a cat",
                 "it's not a dog", "The Train Leaves", "x"]
    zs, us, cps = _grids(rng, sentences, 40)
    cps[:, 0] = ord("_")          # the placeholder: a no-op edit
    cps[:, 1] = -1
    mask = checker.valid_edits(sentences, zs, cps)
    assert mask.shape == zs.shape and mask.dtype == bool
    for i, s in enumerate(sentences):
        edited = [tedits.apply_edit(s, int(z), 0, [int(c)], alternative=-1)
                  for z, c in zip(zs[i], cps[i])]
        assert list(mask[i]) == wc.valid(s, edited), s
    # a no-op edit never strictly decreases the word count
    assert not mask[:, 0].any()
    assert mask.any()


def test_tokenizer_dispatches_and_counts(py_tok):
    tok = tbpe.CLIPTokenizer()
    assert tok._native is None and not tok._native_checked      # lazy
    texts = ["hello world", "a photo of a cat"]
    out = tok(texts)
    assert isinstance(tok._native, nb.NativeBPE)
    np.testing.assert_array_equal(out, py_tok(texts))
    assert tok.counts == {"native_calls": 1, "native_texts": 2,
                          "python_calls": 0, "python_texts": 0}
    # input outside the native contract takes the Python path
    for batch in (["café au lait", "hello"], ["fish & chips"],
                  ["tab\there"]):
        np.testing.assert_array_equal(tok(batch), py_tok(batch))
    assert tok.counts["native_calls"] == 1
    assert tok.counts["python_calls"] == 3
    assert tok.counts["python_texts"] == 4
    # the attacks' grids count as native work
    zs = np.zeros((2, 3), np.int32)
    assert ttext._edit_tokens_fast(tok, texts, zs, zs + ord("a")).shape \
        == (2, 3, 77)
    assert tok.counts["native_texts"] == 2 + 6
    assert ttext._edit_tokens_fast(tok, ["naïve", "x"], zs, zs) is None
    assert ttext._edit_tokens_fast(tok, ["a & b", "x"], zs, zs) is None
    assert ttext._native_of(tok) is tok._native
    assert ttext._native_of(object()) is None


def test_fused_ok_and_constrain_grid(native):
    vocab = tedits.DEFAULT_VOCAB
    ok = ttext._fused_ok
    assert ok(native, None, ["a cat"], vocab)
    assert ok(native, None, ["a cat"], [-1, 65])
    assert not ok(None, None, ["a cat"], vocab)
    assert not ok(native, object(), ["a cat"], vocab)
    assert not ok(native, None, ["a café"], vocab)
    assert not ok(native, None, ["a & b"], vocab)
    assert not ok(native, None, ["a cat"], [233])
    # invalid candidates of a grid are replaced by the clean tokens
    wc = tconstraint.WordConstraint()
    sentences = ["a photo of a cat", "stocks fall"]
    zs, _, cps = _grids(np.random.default_rng(3), sentences, 10)
    tokens = native.encode_edits(sentences, zs, cps, 77).reshape(2, 10, 77)
    before = tokens.copy()
    grid_mask = np.ones((2, 10), bool)
    grid_mask[:, -1] = False
    valid = ttext._constrain_grid(wc, sentences, tokens, grid_mask, zs, cps,
                                  native, 77)
    clean = native.encode_batch(sentences, 77)
    np.testing.assert_array_equal(valid, wc.valid_edits_batch(sentences, zs,
                                                              cps))
    for i in range(2):
        for j in range(10):
            want = clean[i] if (not valid[i, j] and grid_mask[i, j]) \
                else before[i, j]
            np.testing.assert_array_equal(tokens[i, j], want)
    assert ttext._constrain_grid(None, sentences, tokens, grid_mask, zs, cps,
                                 native, 77) is None


def test_build_writes_only_under_an_ignored_directory(native):
    """The library, the merge table and the word lists land in
    `native/build/`, which git ignores; nothing lands in the JAX package
    or in a tracked directory."""
    tconstraint.WordConstraint()._get_native()
    names = os.listdir(nb.BUILD_DIR)
    assert "libbpe_tokenizer.so" in names
    assert any(n.startswith("merges_") and n.endswith(".txt") for n in names)
    assert any(n.startswith("words_") and n.endswith(".txt") for n in names)
    # (another test process may be compiling right now, under its own
    # temporary name; this one has left none behind)
    assert not [n for n in names if n.endswith(f".{os.getpid()}.tmp")]
    assert os.path.commonpath([nb.BUILD_DIR, REPO]) == REPO
    assert "leaf_tpu_torch" in os.path.relpath(nb.BUILD_DIR, REPO)
    native_dir = os.path.dirname(nb.SOURCE)
    assert sorted(os.listdir(native_dir)) == ["bpe_tokenizer.cpp", "build"]
    if os.path.isdir(os.path.join(REPO, ".git")):
        done = subprocess.run(
            ["git", "check-ignore", "-q", os.path.join(nb.BUILD_DIR, "x")],
            cwd=REPO)
        assert done.returncode == 0
        status = subprocess.run(
            ["git", "status", "--porcelain", "--", "leaf_tpu_torch/tokenizer"],
            cwd=REPO, capture_output=True, text=True, check=True).stdout
        assert "build" not in status


def test_a_failed_build_raises():
    """A compiler that is missing, and one that fails, raise with the
    command (and the compiler's output); no Python path is taken in its
    stead.  Run in a fresh process, against a build directory of its own."""
    code = (
        "import os, sys, tempfile\n"
        "from leaf_tpu_torch.tokenizer import native_binding as nb\n"
        "from leaf_tpu_torch.tokenizer.bpe import CLIPTokenizer\n"
        "tmp = tempfile.mkdtemp()\n"
        "nb.BUILD_DIR = tmp\n"
        "nb.LIBRARY = os.path.join(tmp, 'libbpe_tokenizer.so')\n"
        "nb.COMPILER = os.path.join(tmp, 'no-such-compiler')\n"
        "try:\n"
        "    CLIPTokenizer()(['hello'])\n"
        "except nb.NativeBuildError as e:\n"
        "    assert 'no-such-compiler' in str(e), e\n"
        "else:\n"
        "    sys.exit('a missing compiler did not raise')\n"
        "bad = os.path.join(tmp, 'bad.cpp')\n"
        "open(bad, 'w').write('this is not C++;')\n"
        "nb.COMPILER, nb.SOURCE = 'g++', bad\n"
        "try:\n"
        "    nb.library()\n"
        "except nb.NativeBuildError as e:\n"
        "    assert 'error' in str(e) and 'bad.cpp' in str(e), e\n"
        "else:\n"
        "    sys.exit('a failing compile did not raise')\n"
        "assert os.listdir(tmp) == ['bad.cpp'], os.listdir(tmp)\n"
        "print('raised twice')\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.strip() == "raised twice"


def test_env_switch_selects_the_python_path(monkeypatch, py_tok):
    monkeypatch.setenv("LEAF_TPU_NO_NATIVE_TOKENIZER", "1")
    tok = tbpe.CLIPTokenizer()
    texts = ["hello world", "a photo of a cat"]
    np.testing.assert_array_equal(tok(texts), py_tok(texts))
    assert tok.native() is None
    assert tok.counts["native_calls"] == 0 and tok.counts["python_calls"] == 1
    assert nb.get_native(tbpe.DEFAULT_BPE_PATH) is None
    assert tconstraint.WordConstraint()._get_native() is None
    zs = np.zeros((2, 3), np.int32)
    assert ttext._edit_tokens_fast(tok, texts, zs, zs) is None
