"""leaf_tpu_torch's Charmer and bruteforce text attacks, its chunked
scoring and the trainer's `--use_charmer` against the JAX package's, in
fp32 on the CPU at ViT-tiny-test.

One set of JAX-initialised weights goes to both packages (the port's
copy by way of `interop.params_from_jax`), each attack with its own
package's tokenizer and word constraint.  Held: every attack picks the
JAX package's sentences on each of the port's paths (the native grids,
the grids with the constraint's native masks, the string path, and a
non-ASCII sentence that sends a batch to the string path), the
dual-encoder Charmer too; scoring in chunks equals scoring in one call
(losses to 1e-5, the same argmaxes and winner features); one
`run_attack` with `--use_charmer` picks the JAX package's sentences, and
`driver.main --use_charmer` runs a tiny epoch on the CPU.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax

from leaf_tpu.attacks import constraint as jconstraint
from leaf_tpu.attacks import engine as jengine
from leaf_tpu.attacks import text as jtext
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu.train import loop as jloop
from leaf_tpu_torch.attacks import constraint as tconstraint
from leaf_tpu_torch.attacks import engine as tengine
from leaf_tpu_torch.attacks import text as ttext
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer
from leaf_tpu_torch.train import driver as tdriver
from leaf_tpu_torch.train import loop as tloop

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TOL = dict(atol=1e-5, rtol=1e-5)
SENTENCES = ["a photo of a cat", "hello world", "stocks fall!", "x"]
# a short vocabulary keeps the candidate grids small: delete, space,
# letters, a digit and punctuation
VOCAB = [-1] + [ord(c) for c in " aeiostxz7!."]
PATHS = ("grids", "constrained", "string")
# the word constraint's dictionary (the same set for both packages)
WORDS = frozenset(
    "a an the of on in at to is photo cat cats dog wall street stocks fall "
    "hello world dummy caption two sleep sofa snow red old small man "
    "violent horrible imagery".split())


def _towers(seed: int):
    """(JAX text params, the port's text tower) holding the same weights."""
    params = jclip.init_clip(jax.random.PRNGKey(seed),
                             jconfig.get_model_config(MODEL))
    module = tclip.CLIP(tconfig.get_model_config(MODEL))
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return params["text"], module.text.eval()


@pytest.fixture(scope="module")
def pkg():
    jtext_params, ttext_tower = _towers(0)
    return types.SimpleNamespace(
        jtext=jtext_params, ttext=ttext_tower,
        jscorer=jengine.CandidateScorer(jconfig.get_model_config(MODEL),
                                        bucket=128),
        tscorer=tengine.CandidateScorer(tconfig.get_model_config(MODEL),
                                        "cpu", bucket=128),
        jtok=jax_tokenizer(), ttok=port_tokenizer(),
        jwc=jconstraint.WordConstraint(set(WORDS)),
        twc=tconstraint.WordConstraint(set(WORDS)))


@pytest.fixture(scope="module")
def second():
    """A second pair of towers, for the dual-encoder Charmer."""
    return _towers(9)


def _anchors(pkg, sentences, normalize=False):
    """The JAX tower's clean features (numpy), the attacks' anchors."""
    return np.asarray(pkg.jscorer.encode_text(pkg.jtext, pkg.jtok(sentences),
                                              normalize))


def _port_path(mp, pkg, path):
    """The port's path for `path`; returns the constraints (JAX, port)."""
    if path == "string":
        mp.setattr(ttext, "_native_of", lambda tok: None)
    if path == "grids":
        assert ttext._native_of(pkg.ttok) is not None
        return None, None
    return pkg.jwc, pkg.twc


# ---------------------------------------------------------------------------
# the four attacks, each path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
def test_bruteforce_matches_jax(pkg, path):
    s = "a photo of a cat"
    anchor = _anchors(pkg, [s])[0]
    with pytest.MonkeyPatch.context() as mp:
        jwc, twc = _port_path(mp, pkg, path)
        want = jtext.attack_text_bruteforce(
            pkg.jscorer, pkg.jtext, pkg.jtok, s, anchor, vocab=VOCAB,
            constraint=jwc)
        got = ttext.attack_text_bruteforce(
            pkg.tscorer, pkg.ttext, pkg.ttok, s, anchor, vocab=VOCAB,
            constraint=twc)
    assert got == want
    assert got[0] != s or path == "constrained"


@pytest.mark.parametrize("path", PATHS + ("dual",))
def test_charmer_inference_matches_jax(pkg, second, path):
    s = "wall street stocks fall"
    anchor = _anchors(pkg, [s], normalize=True)[0]
    kw_j, kw_t = {}, {}
    if path == "dual":
        jtext2, ttext2 = second
        anchor2 = np.asarray(pkg.jscorer.encode_text(jtext2, pkg.jtok([s]),
                                                     True))[0]
        kw_j = dict(text_params2=jtext2, anchor_features2=anchor2)
        kw_t = dict(text2=ttext2, anchor_features2=anchor2)
    with pytest.MonkeyPatch.context() as mp:
        jwc, twc = _port_path(mp, pkg, "grids" if path == "dual" else path)
        want = jtext.attack_text_charmer_inference(
            pkg.jscorer, pkg.jtext, pkg.jtok, s, anchor, "sim", n=3, k=2,
            vocab=VOCAB, constraint=jwc, **kw_j)
        got = ttext.attack_text_charmer_inference(
            pkg.tscorer, pkg.ttext, pkg.ttok, s, anchor, "sim", n=3, k=2,
            vocab=VOCAB, constraint=twc, **kw_t)
    assert got == want and got[1] == 2


@pytest.mark.parametrize("path", PATHS + ("non_ascii",))
def test_charmer_batched_matches_jax(pkg, path):
    sentences = list(SENTENCES)
    if path == "non_ascii":
        sentences[1] = "café au lait"
    anchors = _anchors(pkg, sentences)
    with pytest.MonkeyPatch.context() as mp:
        jwc, twc = _port_path(mp, pkg,
                              "grids" if path == "non_ascii" else path)
        assert ttext._grids_ok(ttext._native_of(pkg.ttok), twc, sentences,
                               VOCAB) == (path in ("grids", "constrained"))
        want = jtext.attack_text_charmer_batched(
            pkg.jscorer, pkg.jtext, pkg.jtok, sentences, anchors, n=4, k=2,
            vocab=VOCAB, constraint=jwc)
        seconds = {}
        got = ttext.attack_text_charmer_batched(
            pkg.tscorer, pkg.ttext, pkg.ttok, sentences, anchors, n=4, k=2,
            vocab=VOCAB, constraint=twc, seconds=seconds)
    assert got == want
    assert sorted(seconds) == ["device", "host"]
    assert got != sentences
    # each sentence's search is the per-sentence attack's
    if path == "grids":
        assert got == [ttext.attack_text_charmer_inference(
            pkg.tscorer, pkg.ttext, pkg.ttok, s, anchors[i], n=4, k=2,
            vocab=VOCAB)[0] for i, s in enumerate(sentences)]


@pytest.mark.parametrize("path,target", [
    ("grids", None), ("grids", "sim"), ("constrained", None),
    ("string", "l2")])
def test_charmer_constrained_ret_matches_jax(pkg, path, target):
    """Untargeted (repelled from its own features, phase 1 on normalised
    features), and pulled toward or pushed from a target caption."""
    s = "a photo of a cat"
    anchor = None
    objective = target or "l2"
    if target is not None:
        anchor = _anchors(pkg, ["violent horrible imagery"],
                          normalize=target == "sim")[0]
    with pytest.MonkeyPatch.context() as mp:
        jwc, twc = _port_path(mp, pkg, path)
        want = jtext.attack_text_charmer_constrained_ret(
            pkg.jscorer, pkg.jtext, pkg.jtok, s, anchor, objective, n=3,
            k=1, vocab=VOCAB, constraint=jwc)
        got = ttext.attack_text_charmer_constrained_ret(
            pkg.tscorer, pkg.ttext, pkg.ttok, s, anchor, objective, n=3,
            k=1, vocab=VOCAB, constraint=twc)
    assert got == want


def test_grid_counts_and_widths(pkg):
    """The grids count as native texts, and a candidate grid is as wide
    as its widest sentence needs (min(n, slots) x |V| columns)."""
    native = ttext._native_of(pkg.ttok)
    ctx = pkg.ttok.context_length
    _, _, n_slots, _, _ = ttext._fused_probe_grid(native, ["ab", "x"], ctx)
    assert n_slots == [5, 3]
    top = np.tile(np.arange(5), (2, 1))
    tokens, mask, zs, _ = ttext._fused_cand_grid(native, ["ab", "x"], top, 50,
                                                 VOCAB, n_slots, ctx)
    assert tokens.shape == (2, 5 * len(VOCAB), ctx)
    assert mask.sum(axis=1).tolist() == [5 * len(VOCAB), 3 * len(VOCAB)]
    before = pkg.ttok.counts["native_texts"]
    ttext.attack_text_charmer_batched(pkg.tscorer, pkg.ttext, pkg.ttok,
                                      ["ab", "x"], _anchors(pkg, ["ab", "x"]),
                                      n=50, vocab=VOCAB)
    assert pkg.ttok.counts["native_texts"] - before == 2 * 5 + tokens.shape[1] * 2


# ---------------------------------------------------------------------------
# chunked scoring
# ---------------------------------------------------------------------------

def test_chunk_rows_from_shape_and_dtype():
    """ViT-L's text tower: bf16 chunks hold every buffer the trainer
    encodes in one call (the unfused loop's 6,400 candidates at bucket 64),
    fp32 chunks half as many tokens; all multiples of 8."""
    cfg = tconfig.get_model_config("ViT-L-14-quickgelu").text
    for C in tengine.CONTEXT_BUCKETS:
        bf16 = tengine.chunk_rows(cfg, torch.bfloat16, C)
        fp32 = tengine.chunk_rows(cfg, torch.float32, C)
        assert bf16 % 8 == 0 and fp32 % 8 == 0
        assert bf16 * C * 3072 * 2 <= tengine.SCORE_CHUNK_BYTES
        assert abs(bf16 - 2 * fp32) <= 8
    assert tengine.chunk_rows(cfg, torch.bfloat16, 64) >= 6400
    assert tengine.chunk_rows(cfg, torch.bfloat16, 16) >= 6400


def _caption_tokens(pkg, rng, shape):
    words = "a photo of the small red dog cat man on street".split()
    texts = [" ".join(rng.choice(words, size=int(rng.integers(1, 7))))
             for _ in range(int(np.prod(shape)))]
    return pkg.ttok(texts).reshape(*shape, -1)


@pytest.mark.parametrize("call", ["score_rows", "score_flat",
                                  "score_classification_rows"])
def test_chunked_scoring_equals_one_call(pkg, call, monkeypatch):
    """A chunk limit of 5 x 8 candidates splits rows of 13 across chunks;
    the result is that of one call."""
    rng = np.random.default_rng(3)
    cfg = tconfig.get_model_config(MODEL)
    one = tengine.CandidateScorer(cfg, "cpu", bucket=8)
    tiny = tengine.CandidateScorer(cfg, "cpu", bucket=8)
    D = cfg.embed_dim
    B, N = 7, 13
    mask = rng.random((B, N)) < 0.8
    mask[:, 0] = True

    def both(score):
        """score(scorer) in one call, then in chunks of 40 candidates."""
        first = score(one)
        with monkeypatch.context() as mp:
            mp.setattr(tengine, "SCORE_CHUNK_BYTES", 40 * 16 * 256 * 4)
            assert tengine.chunk_rows(cfg.text, torch.float32, 16) == 40
            return first, score(tiny)

    if call == "score_rows":
        tokens = _caption_tokens(pkg, rng, (B, N))
        anchors = rng.standard_normal((B, D)).astype(np.float32)
        out = both(lambda s: s.score_rows(pkg.ttext, tokens, anchors, "l2",
                                          mask=mask))
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_allclose(out[1][2].numpy(), out[0][2].numpy(), **TOL)
        np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(), **TOL)
    elif call == "score_flat":
        tokens = _caption_tokens(pkg, rng, (B * N,))
        anchor = rng.standard_normal(D).astype(np.float32)
        out = both(lambda s: s.score_flat(pkg.ttext, tokens, anchor,
                                          "l2_normfeat"))
        np.testing.assert_allclose(out[1], out[0], **TOL)
        assert out[1].argmax() == out[0].argmax()
    else:
        tokens = _caption_tokens(pkg, rng, (B, N))
        feats = rng.standard_normal((3, D)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        labels = rng.integers(0, 3, B)
        out = both(lambda s: s.score_classification_rows(
            pkg.ttext, tokens, feats, labels, mask))
        np.testing.assert_allclose(out[1][0], out[0][0], **TOL)
        np.testing.assert_array_equal(out[1][1], out[0][1])
        np.testing.assert_array_equal(out[1][0].argmax(1), out[0][0].argmax(1))
    assert one.counts["encodes"] == one.counts["calls"] == 1
    assert tiny.counts["encodes"] == -(-B * N // 40)
    assert tiny.counts["candidates"] == B * N or call == "score_flat"


# ---------------------------------------------------------------------------
# the trainer's --use_charmer
# ---------------------------------------------------------------------------

def test_run_attack_use_charmer_matches_jax(pkg):
    texts = ["Dummy caption", "two cats sleep on the sofa", "snow"]
    anchors = _anchors(pkg, texts)
    args = types.SimpleNamespace(use_charmer=True, rho=4, k_adv=1,
                                 attack_objective="l2")
    want = jloop.run_attack(pkg.jscorer, pkg.jtext, pkg.jtok, texts, anchors,
                            args, VOCAB, None, None)
    seconds = {}
    got = tloop.run_attack(pkg.tscorer, pkg.ttext, pkg.ttok, texts,
                           torch.tensor(anchors), args, VOCAB, None, None,
                           seconds)
    assert got == want and got != texts
    assert seconds["host"] > 0 and seconds["device"] > 0


def test_driver_use_charmer_runs_on_cpu(tmp_path):
    out = tdriver.main([
        "--model", MODEL, "--dataset-type", "synthetic",
        "--train-num-samples", "8", "--batch-size", "4", "--epochs", "1",
        "--rho", "4", "--warmup", "2", "--lr", "1e-4",
        "--zeroshot-frequency", "0", "--log-every-n-steps", "1",
        "--use_charmer", "--device", "cpu",
        "--logs", str(tmp_path), "--name", "charmer"])
    assert out["fused_step"] is None
    with open(os.path.join(out["out_dir"], "times_True.csv")) as f:
        times = f.read().split()
    assert times[0] == "0" and len(times) == 3
    assert out["attack_seconds"]["device"] > 0
    assert [r["epoch"] for r in out["results"]] == [0, 1]
    assert float(out["results"][1]["train_loss"]) > 0
