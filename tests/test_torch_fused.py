"""leaf_tpu_torch's fused attack+train step against the JAX package's
(`leaf_tpu.train.fused.FusedLeafStep`) and against the port's own unfused
path, in fp32 on the CPU.

Both packages start from the same JAX-initialised text tower (the port's
copy by way of `interop.params_from_jax`), the same captions and a numpy
generator of the same seed, and both tokenize through their native
libraries.  Discrete decisions (positions, characters, winners,
adversarial sentences) must be identical; losses agree to 1e-5 relative;
parameters after 3 Adam steps at lr 1e-4 to 1e-5 absolute (the
attention's key bias, whose true gradient is zero, to 3 * lr: see
`tests/test_torch_train.py`).  These re-express `tests/test_fused_step.py`.
"""
import copy
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from leaf_tpu.attacks.constraint import WordConstraint as JWordConstraint
from leaf_tpu.models import clip as jclip
from leaf_tpu.models import config as jconfig
from leaf_tpu.tokenizer import get_tokenizer as jax_tokenizer
from leaf_tpu.train import fused as jfused
from leaf_tpu.train import optim as joptim
from leaf_tpu.train import schedules as jschedules
from leaf_tpu.train import step as jstep
from leaf_tpu_torch.attacks.constraint import WordConstraint
from leaf_tpu_torch.attacks.engine import CandidateScorer, bucket_tokens
from leaf_tpu_torch.attacks.text import attack_text_leaf
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.models import interop as tinterop
from leaf_tpu_torch.tokenizer import get_tokenizer as port_tokenizer
from leaf_tpu_torch.train import fused as tfused
from leaf_tpu_torch.train import optim as toptim
from leaf_tpu_torch.train import schedules as tschedules
from leaf_tpu_torch.train import step as tstep
from leaf_tpu_torch.utils.results import AsyncAttackTimer, TimingLedger

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
LR = 1e-4       # see tests/test_torch_train.py on comparing two Adams
TEXTS = ["a photo of a cat", "stocks rally on earnings",
         "the match ended in a draw", "hello world"]
MORE = ["another day at the office", "rain over the hills",
        "a plate of pasta", "two dogs playing"]
OPT = dict(weight_decay=1e-4, beta1=0.9, beta2=0.98, eps=1e-6)


@pytest.fixture(scope="module")
def towers():
    """(JAX config, JAX text params, the port's config, a state_dict of the
    port's text tower with the same weights)."""
    jcfg = jconfig.get_model_config(MODEL)
    params = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    tcfg = tconfig.get_model_config(MODEL)
    module = tclip.CLIP(tcfg)
    module.load_state_dict(tinterop.params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jcfg, params["text"], tcfg, module.text.state_dict()


def _port_state(towers, sgd: float = 0.0):
    """(state, frozen tower) of the port, from the shared weights."""
    _, _, tcfg, sd = towers
    text = tclip.TextTower(tcfg.text, tcfg.quick_gelu)
    text.load_state_dict(sd)
    frozen = copy.deepcopy(text).requires_grad_(False)
    opt = toptim.make_optimizer(text.named_parameters(),
                                tschedules.cosine_lr(LR, 1, 100), **OPT)
    if sgd:
        opt = _Sgd(text, sgd)
    return tstep.TrainState.create(text, opt), frozen


class _Sgd:
    """Plain SGD with the optimizer's `update` interface."""

    def __init__(self, text, lr):
        self.params, self.lr = list(text.parameters()), lr

    def update(self, step):
        with torch.no_grad():
            for p in self.params:
                p -= self.lr * p.grad
                p.grad = None
        return torch.zeros(())


def _port_fused(towers, **kw):
    return tfused.FusedLeafStep(towers[2], port_tokenizer(), device="cpu",
                                **kw)


def _jax_run(towers, batches, seed, **kw):
    """The JAX fused step over `batches`: (infos with host values, final
    text params)."""
    jcfg, jtext, _, _ = towers
    constraint = JWordConstraint() if kw.pop("constrain", False) else None
    tx = joptim.make_optimizer(
        lambda s: jnp.asarray(jschedules.cosine_lr(LR, 1, 100)(s)), **OPT)
    fused = jfused.FusedLeafStep(jcfg, tx, jax_tokenizer(),
                                 constraint=constraint, **kw)
    state = jstep.TrainState.create(jax.tree.map(jnp.copy, jtext), tx)
    frozen = jax.tree.map(jnp.copy, jtext)
    rng = np.random.default_rng(seed)
    out = []
    for texts in batches:
        state, info = fused(state, frozen, list(texts), rng)
        out.append({"best_pos": list(info["best_pos"]),
                    "us": np.asarray(info["us"]),
                    "adv": fused.adv_sentences(list(texts), info),
                    "loss": float(info["metrics"]["loss"])})
    return out, state.text_params


def _port_run(towers, batches, seed, overlap=False, **kw):
    constraint = WordConstraint() if kw.pop("constrain", False) else None
    fused = _port_fused(towers, constraint=constraint, **kw)
    state, frozen = _port_state(towers)
    rng = np.random.default_rng(seed)
    out, prepared = [], None
    for i, texts in enumerate(batches):
        state, info = fused(state, frozen, list(texts), rng,
                            prepared=prepared)
        prepared = None
        if overlap and i + 1 < len(batches):
            prepared = fused.prepare_probes(list(batches[i + 1]), rng)
        out.append({"best_pos": list(info["best_pos"]),
                    "us": np.asarray(info["us"]),
                    "adv": fused.adv_sentences(list(texts), info),
                    "loss": float(info["metrics"]["loss"]), "info": info})
    return out, state, fused


def _same_decisions(got, want):
    for g, w in zip(got, want):
        assert g["best_pos"] == w["best_pos"]
        np.testing.assert_array_equal(g["us"], w["us"])
        assert g["adv"] == w["adv"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)


def _same_params(text, jparams, steps):
    want = tinterop.params_from_jax(jax.tree.map(np.asarray, jparams))
    got = text.state_dict()
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.endswith("attn.qkv_b"):
            # the key bias has an exactly zero true gradient; Adam turns
            # each framework's rounding noise there into up to lr per step
            third = len(w) // 3
            np.testing.assert_allclose(g[third:2 * third], w[third:2 * third],
                                       atol=steps * LR, rtol=0, err_msg=name)
            g, w = np.delete(g, np.s_[third:2 * third]), \
                np.delete(w, np.s_[third:2 * third])
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# port against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("unpipelined", dict(rho=6, pipeline=False)),
    ("pipelined", dict(rho=5)),
    ("constrained", dict(rho=8, constrain=True, pipeline=False)),
    ("constrained-pipelined", dict(rho=6, constrain=True)),
    ("k2", dict(rho=6, k=2)),
    ("k2-constrained", dict(rho=6, k=2, constrain=True)),
])
def test_fused_step_matches_jax(towers, name, kw):
    """Three steps (the second and third hit the anchor cache): the same
    positions, characters, adversarial sentences, losses and parameters."""
    batches = [TEXTS, MORE, TEXTS]
    want, jparams = _jax_run(towers, batches, 7, **kw)
    got, state, fused = _port_run(towers, batches, 7, **kw)
    _same_decisions(got, want)
    assert state.step == 3
    _same_params(state.text, jparams, 3)
    pipelined = isinstance(got[0]["info"]["best_char_idx"], tuple)
    assert pipelined == (name in ("pipelined", "constrained-pipelined"))
    # the candidate grids went through the native library
    assert fused.tokenizer.counts["native_texts"] > 0
    assert any(a != t for a, t in zip(got[0]["adv"], TEXTS))


def test_prepared_probes_match_jax_and_the_unoverlapped_stream(towers):
    """`prepare_probes` for batch i+1 after batch i's step draws from the
    generator in the unoverlapped order: same decisions as the JAX step
    (which prepares inside the call) and as the port's own."""
    batches = [TEXTS, MORE]
    want, _ = _jax_run(towers, batches, 11, rho=5)
    plain, state_a, _ = _port_run(towers, batches, 11, rho=5)
    over, state_b, _ = _port_run(towers, batches, 11, overlap=True, rho=5)
    _same_decisions(over, want)
    _same_decisions(over, plain)
    for a, b in zip(state_a.text.parameters(), state_b.text.parameters()):
        assert torch.equal(a, b)


def test_info_keys_are_the_jax_steps(towers):
    want_keys = {"best_pos", "best_char_idx", "us", "base_texts", "metrics",
                 "attack_marker"}
    for kw in (dict(rho=4), dict(rho=4, pipeline=False)):
        got, _, _ = _port_run(towers, [TEXTS], 0, **kw)
        info = got[0]["info"]
        assert set(info) == want_keys
        assert set(info["metrics"]) == {"loss", "grad_norm"}
        assert info["attack_marker"] is None      # a CPU step: already done
        assert info["base_texts"] == TEXTS


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("constrain", [False, True],
                         ids=["free", "constrained"])
@pytest.mark.parametrize("k", [1, 2])
def test_fused_equals_unfused(towers, k, constrain):
    """The fused step against `attack_text_leaf` + the plain train step:
    identical adversarial sentences, loss to 1e-5, parameters to 1e-6."""
    tcfg = towers[2]
    rho = 6
    wc = WordConstraint() if constrain else None
    tok = port_tokenizer()

    state_a, frozen = _port_state(towers)
    scorer = CandidateScorer(tcfg, "cpu")
    rng_a = np.random.default_rng(13)
    clean = torch.from_numpy(bucket_tokens(tok(TEXTS)))
    anchors = tstep.make_anchor_encode()(frozen, clean)
    _, adv_texts = attack_text_leaf(scorer, state_a.text, tok, list(TEXTS),
                                    anchors, objective="l2", n=rho, k=k,
                                    constraint=wc, rng=rng_a)
    adv_tokens = torch.from_numpy(bucket_tokens(tok(adv_texts)))
    state_a, metrics_a = tstep.make_train_step()(state_a, adv_tokens, anchors)

    state_b, frozen_b = _port_state(towers)
    fused = _port_fused(towers, rho=rho, constraint=wc, k=k, pipeline=False)
    state_b, info = fused(state_b, frozen_b, list(TEXTS),
                          np.random.default_rng(13))
    assert fused.adv_sentences(list(TEXTS), info) == adv_texts
    np.testing.assert_allclose(float(info["metrics"]["loss"]),
                               float(metrics_a["loss"]), rtol=1e-5)
    for a, b in zip(state_a.text.parameters(), state_b.text.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_string_path_equals_native_path(towers, monkeypatch):
    """With the Python tokenizer asked for by name, the fused step builds
    its candidates from strings and picks the same sentences."""
    batches = [TEXTS, MORE]
    native, state_n, fused_n = _port_run(towers, batches, 5, rho=5,
                                         constrain=True)
    monkeypatch.setenv("LEAF_TPU_NO_NATIVE_TOKENIZER", "1")
    from leaf_tpu_torch.tokenizer.bpe import CLIPTokenizer
    fused = tfused.FusedLeafStep(towers[2], CLIPTokenizer(), rho=5,
                                 constraint=WordConstraint(), device="cpu")
    state, frozen = _port_state(towers)
    rng = np.random.default_rng(5)
    for texts, want in zip(batches, native):
        state, info = fused(state, frozen, list(texts), rng)
        assert fused.adv_sentences(list(texts), info) == want["adv"]
        np.testing.assert_allclose(float(info["metrics"]["loss"]),
                                   want["loss"], rtol=1e-6)
    assert fused.tokenizer.counts["native_calls"] == 0
    assert fused.tokenizer.counts["python_texts"] > 0
    assert fused_n.tokenizer.counts["native_texts"] > 0


def test_anchor_cache_is_exact(towers):
    """Steps with the anchor cache reproduce the uncached run bit for bit,
    and the cached rows live on the tower's device."""
    outs = []
    for cache in (False, True):
        got, state, fused = _port_run(towers, [TEXTS] * 3, 3, rho=4,
                                      cache_anchors=cache)
        outs.append((got, state))
        if cache:
            assert set(fused.anchor_cache) == set(TEXTS)
            assert all(isinstance(v, torch.Tensor)
                       for v in fused.anchor_cache.values())
        else:
            assert fused.anchor_cache is None
    assert [g["loss"] for g in outs[0][0]] == [g["loss"] for g in outs[1][0]]
    for a, b in zip(outs[0][1].text.parameters(),
                    outs[1][1].text.parameters()):
        assert torch.equal(a, b)


def test_anchor_cache_guard(towers):
    fused = _port_fused(towers, rho=4)
    fused.MAX_CACHED_ANCHORS = 2      # instance override: a full cache
    state, frozen = _port_state(towers)
    rng = np.random.default_rng(0)
    state, _ = fused(state, frozen, list(TEXTS), rng)
    filled = len(fused.anchor_cache)
    assert 2 <= filled <= len(TEXTS)
    state, _ = fused(state, frozen, list(MORE), rng)
    assert len(fused.anchor_cache) == filled      # no growth past the guard


def test_pipelined_equals_unpipelined(towers):
    """Same winners and losses over 3 Adam steps (parameters drift at the
    noise level of the loss's reduction order, so they are held under SGD
    below)."""
    piped, _, _ = _port_run(towers, [TEXTS, MORE, TEXTS], 23, rho=5)
    plain, _, _ = _port_run(towers, [TEXTS, MORE, TEXTS], 23, rho=5,
                            pipeline=False)
    _same_decisions(piped, plain)


def test_pipelined_grads_equal_under_sgd(towers):
    """SGD parameters are lr * gradient, so this pins the gradient math of
    the two half sums against the full-batch mean.  The residual `anchors -
    feats` cancels two values of about 1, so fp32 noise shows at ~1e-4
    relative in the gradients: atol 5e-5, as the JAX package's test."""
    finals = []
    for pipeline in (True, False):
        fused = _port_fused(towers, rho=5, pipeline=pipeline)
        state, frozen = _port_state(towers, sgd=0.1)
        rng = np.random.default_rng(23)
        for _ in range(2):
            state, _ = fused(state, frozen, list(TEXTS), rng)
        finals.append([p.detach().clone() for p in state.text.parameters()])
    moved = 0.0
    for a, b, p0 in zip(finals[0], finals[1], towers[3].values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-5)
        moved = max(moved, float((a - p0).abs().max()))
    assert moved > 1e-3


def test_use_pipeline_decision_matrix(towers):
    f = _port_fused(towers, rho=5)
    assert f._use_pipeline(128)            # the recipe's batch
    assert f._use_pipeline(4)
    assert not f._use_pipeline(2)          # halves of 1: nothing to overlap
    assert not f._use_pipeline(5)          # odd batch
    assert not _port_fused(towers, rho=5, k=2)._use_pipeline(128)
    assert not _port_fused(towers, rho=5, pipeline=False)._use_pipeline(128)


def test_pipelined_heterogeneous_halves_share_bucket(towers):
    """Halves whose captions land in different context buckets: each half's
    candidates are padded up to the full batch's probe bucket, and winners
    and loss equal the unpipelined step's."""
    texts = ["a cat", "hi there",
             "an extremely long caption about the market rally that "
             "keeps going with many more words to cross a bucket "
             "boundary for sure",
             "another quite long sentence padded with extra words to "
             "stay in the wide context bucket alongside its neighbour"]
    seen = []
    fused_p = _port_fused(towers, rho=5)
    score = fused_p.phase2_score

    def spy(text, cand_tokens, anchors):
        seen.append(tuple(cand_tokens.shape))
        return score(text, cand_tokens, anchors)

    fused_p.phase2_score = spy
    state, frozen = _port_state(towers)
    state, info_p = fused_p(state, frozen, list(texts),
                            np.random.default_rng(41))
    plain, _, _ = _port_run(towers, [texts], 41, rho=5, pipeline=False)
    assert fused_p.adv_sentences(texts, info_p) == plain[0]["adv"]
    np.testing.assert_allclose(float(info_p["metrics"]["loss"]),
                               plain[0]["loss"], rtol=1e-5)
    assert isinstance(info_p["best_char_idx"], tuple)
    assert len(seen) == 2 and seen[0] == seen[1] and seen[0][-1] == 32


def test_filter_tokens_replaces_invalid_rows_only():
    tokens = np.arange(2 * 3 * 4).reshape(2, 3, 4)
    clean = -np.ones((2, 4), int)
    valid = np.array([[True, False, True], [True, True, True]])
    out = tfused._filter_tokens(tokens, clean, valid)
    assert (out[0, 1] == -1).all() and (tokens[0, 1] != -1).all()
    np.testing.assert_array_equal(np.delete(out.reshape(6, 4), 1, 0),
                                  np.delete(tokens.reshape(6, 4), 1, 0))
    assert tfused._filter_tokens(tokens, clean, valid | True) is tokens


def test_ties_take_the_first_candidate(towers):
    """Under the constraint several candidates of a row are the clean
    sentence's tokens and score the same: argmax takes the first, as
    `jnp.argmax`."""
    tcfg, sd = towers[2], towers[3]
    text = tclip.TextTower(tcfg.text, tcfg.quick_gelu)
    text.load_state_dict(sd)
    tok = port_tokenizer()
    row = torch.from_numpy(bucket_tokens(tok(["a photo of a cat"])))
    tokens = row[:, None, :].repeat(1, 5, 1)
    anchors = torch.zeros(1, tcfg.embed_dim)
    best = tfused.make_fused_phase1_cached()(text, tokens, anchors)
    assert best.tolist() == [0]
    best, adv = tfused.make_fused_phase2_score()(text, tokens, anchors)
    assert best.tolist() == [0] and torch.equal(adv, row)


# ---------------------------------------------------------------------------
# the attack timer
# ---------------------------------------------------------------------------

class _Marker:
    """Stands in for a CUDA event that becomes ready after `seconds`."""

    def __init__(self, seconds):
        self.seconds = seconds

    def synchronize(self):
        time.sleep(self.seconds)


def test_async_attack_timer_writes_one_row_per_step_in_order(tmp_path):
    """The worker waits on each step's marker in turn without holding the
    submitting thread back; a CPU step (marker None) ends when it is
    submitted; `close` leaves one row per step, in step order."""
    path = str(tmp_path / "times_False.csv")
    ledger = TimingLedger(path)
    timer = AsyncAttackTimer(ledger)
    waits = [0.3, 0.0, 0.2, None, 0.1]
    t0 = time.perf_counter()
    starts = []
    for w in waits:
        starts.append(time.perf_counter())
        timer.submit(starts[-1], None if w is None else _Marker(w))
    submitted_in = time.perf_counter() - t0
    assert submitted_in < 0.25          # submitting never waits for a marker
    timer.close()
    assert not timer._thread.is_alive()
    with open(path) as f:
        rows = f.read().split()
    assert rows[0] == "0" and len(rows) == 1 + len(waits)
    times = [float(r) for r in rows[1:]]
    assert times == ledger.times and timer.last == times[-1]
    # FIFO: step i is ready no earlier than the waits before it add up to
    assert times[0] >= 0.3 and times[2] >= 0.5 - (starts[2] - starts[0])
    assert times[3] < 0.25              # marker None: ready at submission
    assert times[4] >= 0.6 - (starts[4] - starts[0])
