"""`leaf_tpu_torch.utils.tracing`: spans and counts kept only under a
recording, their nesting, their ranges under `torch.profiler`, and the
spans of the LEAF and FARE trainers at a tiny size on the CPU."""
import os
import re

import numpy as np
import pytest
import torch

from leaf_tpu_torch.attacks.engine import bucket_tokens
from leaf_tpu_torch.models import clip as tclip
from leaf_tpu_torch.models import config as tconfig
from leaf_tpu_torch.tokenizer import get_tokenizer
from leaf_tpu_torch.train import fare as tfare
from leaf_tpu_torch.train import fused as tfused
from leaf_tpu_torch.train import optim as toptim
from leaf_tpu_torch.train import schedules as tschedules
from leaf_tpu_torch.train import step as tstep
from leaf_tpu_torch.utils import tracing

torch.set_num_threads(2)

MODEL = "ViT-tiny-test"
TEXTS = ["a photo of a cat", "stocks rally on earnings",
         "the match ended in a draw", "hello world"]
PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "leaf_tpu_torch")
GRID = ("train.fused.prepare", "train.fused.candidates", "train.fused.clean")


def _tree(spans):
    """[(name, parent's name or None)] in open order."""
    return [(s.name, None if s.parent is None else spans[s.parent].name)
            for s in spans]


def test_spans_nest_and_are_kept_only_under_a_recording():
    with tracing.recording():
        with tracing.span("train.a", slots=2) as a:
            assert a
            with tracing.span("train.b") as b:
                b.add("slots", 3)
                b.add("slots", 4)
                b.add("own_tokens", lambda: 5)
            with tracing.span("train.c"):
                pass
        with tracing.span("train.d"):
            pass
    outside = tracing.span("train.e")
    with outside as e:
        assert not e
        e.add("slots", 1)
    spans = tracing.recorded()
    assert _tree(spans) == [("train.a", None), ("train.b", "train.a"),
                            ("train.c", "train.a"), ("train.d", None)]
    assert spans[0].counts == {"slots": 2}
    assert spans[1].counts == {"slots": 7, "own_tokens": 5}
    assert all(s.device_ms is None for s in spans)
    assert all(0 <= s.ms for s in spans)
    assert spans[0].ms >= spans[1].ms + spans[2].ms
    # off: one shared object, no record, the last recording kept
    assert tracing.span("train.f") is tracing.span("train.g", slots=1)
    assert _tree(tracing.recorded())[-1] == ("train.d", None)
    # a new recording clears the last
    with tracing.recording():
        pass
    assert tracing.recorded() == []


def test_a_span_open_when_a_recording_starts_or_stops_is_left_out():
    with tracing.span("train.before"):
        with tracing.recording():
            with tracing.span("train.inside"):
                pass
            late = tracing.span("train.late")
            late.__enter__()
    late.__exit__(None, None, None)
    assert _tree(tracing.recorded()) == [("train.inside", None)]


def test_under_the_profiler_each_span_is_a_range():
    from torch.profiler import ProfilerActivity, profile
    outer = tracing.span("train.outer")
    outer.__enter__()              # opened before the session: left out
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    with tracing.span("train.one"):
        with tracing.span("train.two", slots=1):
            torch.ones(4).sum()
    outer.__exit__(None, None, None)
    stopped = tracing.span("train.three")
    stopped.__enter__()            # closed after the session: left out
    prof.__exit__(None, None, None)
    stopped.__exit__(None, None, None)
    names = [e.name for e in prof.events()]
    assert "train.one" in names and "train.two" in names
    assert "train.outer" not in names
    assert _tree(tracing.recorded()) == [("train.one", None),
                                         ("train.two", "train.one")]
    # no range is left open, and a second session is a new recording
    with profile(activities=[ProfilerActivity.CPU]) as again:
        with tracing.span("train.four"):
            pass
    assert [e.name for e in again.events()
            if e.name.startswith("train.")] == ["train.four"]
    assert _tree(tracing.recorded()) == [("train.four", None)]


def test_a_trace_window_lets_its_recording_go(tmp_path):
    """`--profile-dir`'s window has no reader of the spans: it drops them,
    and the values their counts hold, when it closes."""
    window = tracing.TraceWindow(str(tmp_path), epoch=0, first=0, stop=2)
    held = torch.ones(3)
    for i in range(3):
        window.step(i)
        with tracing.span("train.step") as s:
            pass
        if s:
            s.add("own_tokens", lambda: int(held.sum()))
    assert window.prof is None and len(os.listdir(tmp_path)) == 1
    assert tracing._RECORDER.spans == [] and tracing.recorded() == []


def test_no_span_name_is_a_benchmark_range():
    """Every span the package opens is named by a literal under `train.`;
    the benchmark's ranges are `leaf.*`, `fare.*` and `portbench.*`."""
    names = set()
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    source = fh.read()
                names |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", source))
    assert {"train.fused.step", "train.fused.wait", "train.optim.update",
            "train.loop.next_batch"} <= names
    assert all(n.startswith("train.") for n in names), names
    assert not any(n.startswith(("leaf.", "fare.", "portbench."))
                   for n in names)


@pytest.fixture(scope="module")
def tiny():
    cfg = tconfig.get_model_config(MODEL)
    torch.manual_seed(0)
    module = tclip.CLIP(cfg)
    return cfg, module


def _state(tiny):
    cfg, module = tiny
    text = tclip.TextTower(cfg.text, cfg.quick_gelu)
    text.load_state_dict(module.text.state_dict())
    frozen = tclip.TextTower(cfg.text, cfg.quick_gelu)
    frozen.load_state_dict(module.text.state_dict())
    frozen.requires_grad_(False)
    opt = toptim.make_optimizer(text.named_parameters(),
                                tschedules.cosine_lr(1e-4, 1, 100))
    return tstep.TrainState.create(text, opt), frozen


def _own_by_hand(rows, eot):
    """Tokens from SOT to EOT of each row, counted in a loop."""
    return sum(list(r).index(eot) + 1
               for r in rows.reshape(-1, rows.shape[-1]))


@pytest.mark.parametrize("pipeline", [True, False])
def test_fused_step_spans_in_order_with_their_counts(tiny, pipeline):
    cfg, _ = tiny
    tok = get_tokenizer()
    eot = int(np.asarray(tok(["a"]))[0].max())
    fs = tfused.FusedLeafStep(cfg, tok, rho=3, device="cpu",
                              pipeline=pipeline)
    state, frozen = _state(tiny)
    rng = np.random.default_rng(1)
    host = fs.seconds["host"]
    with tracing.recording():
        state, info = fs(state, frozen, TEXTS, rng)
    spans = tracing.recorded()
    host = fs.seconds["host"] - host
    enq = "train.fused.enqueue."
    step = "train.fused.step"
    if pipeline:
        want = [(step, None), ("train.fused.prepare", step),
                ("train.fused.clean", step)]
        want += [(enq + "phase1", step)] * 2
        for _ in range(2):
            want += [("train.fused.wait", step),
                     ("train.fused.candidates", step), (enq + "score", step)]
        want += [(enq + "update", step),
                 ("train.optim.update", enq + "update")]
    else:
        want = [(step, None), ("train.fused.prepare", step),
                ("train.fused.clean", step), (enq + "phase1", step),
                ("train.fused.wait", step), ("train.fused.candidates", step),
                (enq + "score", step), (enq + "update", step),
                ("train.optim.update", enq + "update")]
    assert _tree(spans) == want
    # the grid spans are the host counter's seconds
    grid_ms = sum(s.ms for s in spans if s.name in GRID)
    assert grid_ms == pytest.approx(1e3 * host, rel=0.02, abs=0.05)
    # slots and own tokens against a count by hand of the grids
    rng = np.random.default_rng(1)
    prepared = fs._prepare(list(TEXTS), rng)
    probes = bucket_tokens(prepared["probe_raw"])
    clean = bucket_tokens(np.asarray(tok(TEXTS)))
    cands = []
    halves = ((slice(0, 2), slice(2, 4)) if pipeline else (slice(0, 4),))
    us = info["us"]
    for rows in halves:
        best_pos = info["best_pos"][rows]
        cands.append(bucket_tokens(fs._candidates(TEXTS[rows], best_pos,
                                                  us[rows], None)))
    adv = tok(fs.adv_sentences(TEXTS, info))
    adv = bucket_tokens(np.asarray(adv))
    by_name = {}
    for s in spans:
        if s.name.startswith(enq):
            kind = s.name[len(enq):]
            for k, v in s.counts.items():
                by_name.setdefault(kind, {}).setdefault(k, 0)
                by_name[kind][k] += v
    # one bucket: one encode per grid (probes and clean rows a half)
    assert by_name["phase1"] == {
        "slots": probes.size + clean.size,
        "own_tokens": _own_by_hand(probes, eot) + _own_by_hand(clean, eot),
        "groups": 2 * len(halves)}
    assert by_name["score"] == {
        "slots": sum(c.size for c in cands),
        "own_tokens": sum(_own_by_hand(c, eot) for c in cands),
        "groups": len(halves)}
    assert by_name["update"]["slots"] == sum(
        len(TEXTS) // len(halves) * c.shape[-1] for c in cands)
    assert by_name["update"]["own_tokens"] == _own_by_hand(adv, eot)
    assert by_name["update"]["groups"] == len(halves)
    # on the CPU no readback is early or late: no count
    assert all(s.counts == {} for s in spans if s.name == "train.fused.wait")


@pytest.mark.parametrize("pipeline", [True, False])
def test_fused_step_slots_count_the_groups_encoded(tiny, pipeline,
                                                   monkeypatch):
    """Captions of buckets 16 and 32 in one batch, each scored at its own
    bucket: the scoring spans' slots are each caption's rows times its
    bucket, summed, below the whole grid's, and `groups` counts the
    encodes: more than one a scoring grid."""
    monkeypatch.setattr(tfused, "SPLIT_MIN_SLOTS", 0)
    cfg, _ = tiny
    tok = get_tokenizer()
    long = ("an extremely long caption about the market rally that keeps "
            "going with many more words to cross a bucket boundary")
    texts = ["a photo of a cat", long, "hello world", long + " for sure"]
    fs = tfused.FusedLeafStep(cfg, tok, rho=3, device="cpu",
                              pipeline=pipeline)
    state, frozen = _state(tiny)
    rng = np.random.default_rng(4)
    prepared = fs._prepare(list(texts), np.random.default_rng(4))
    with tracing.recording():
        state, info = fs(state, frozen, texts, rng)
    spans = tracing.recorded()
    halves = ((slice(0, 2), slice(2, 4)) if pipeline else (slice(0, 4),))

    def own_buckets(grid):
        return sum(bucket_tokens(g).size for g in grid)

    grids = {"phase1": [prepared["probe_raw"]], "score": []}
    for rows in halves:
        grids["score"].append(fs._candidates(
            texts[rows], info["best_pos"][rows], info["us"][rows], None))
    clean = bucket_tokens(np.asarray(tok(texts)))
    got = {}
    for s in spans:
        if s.name.startswith("train.fused.enqueue."):
            kind = s.name.rsplit(".", 1)[1]
            for k, v in s.counts.items():
                got.setdefault(kind, {}).setdefault(k, 0)
                got[kind][k] += v
    assert got["phase1"]["slots"] == own_buckets(grids["phase1"][0]) \
        + clean.size
    assert got["score"]["slots"] == sum(own_buckets(g)
                                        for g in grids["score"])
    # each half, or the batch, holds both buckets: two encodes a grid,
    # plus the clean rows' one
    assert got["phase1"]["groups"] == 3 * len(halves)
    assert got["score"]["groups"] == 2 * len(halves)
    assert got["update"]["groups"] == len(halves)
    whole = bucket_tokens(prepared["probe_raw"]).size
    assert own_buckets(grids["phase1"][0]) < whole


def test_fare_spans_in_order_and_its_times_unchanged(tiny):
    cfg, module = tiny
    fcfg = tfare.FareConfig(steps=2, warmup=1, lr=1e-4, eps=2 / 255,
                            iterations_adv=1, stepsize_adv=1 / 255,
                            log_freq=1, fallback_freq=0)
    images = np.random.default_rng(0).uniform(
        0.2, 0.8, (2, 64, 64, 3)).astype(np.float32)

    def batches():
        while True:
            yield images, None

    def run():
        visual = tclip.VisionTower(cfg.vision, cfg.quick_gelu)
        visual.load_state_dict(module.visual.state_dict())
        return tfare.train_fare(visual, cfg, fcfg, batches(), seed=3)

    plain = run()
    with tracing.recording():
        got = run()
    spans = tracing.recorded()
    assert _tree(spans) == [("train.optim.update", None)] * 2
    assert all(s.device_ms is None for s in spans)
    assert got["final_loss"] == plain["final_loss"]
    assert [sorted(t) for t in got["times"]] == [
        sorted(t) for t in plain["times"]] == [
        ["anchor_s", "attack_s", "step_s", "update_s", "wait_s"]] * 2
