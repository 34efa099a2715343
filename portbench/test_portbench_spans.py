"""The readers of the program's spans on a made-up trace and made-up
recorded spans: the placement on the trace's clock by the enclosing
benchmark ranges, the split of idle time by the innermost span, nothing
where the clocks do not line up, and the counts' ratios by hand."""
from __future__ import annotations

import sys

import pytest

from leaf_tpu_torch.utils.tracing import Span
from portbench.harness import Spec
from portbench.metrics import arith
from portbench.metrics import spans as program
from portbench.trace import WINDOW, Trace

HOST0 = 100.0     # the host clock's seconds at the trace's 0


def _span(name, parent, start, end, device_ms=None, **counts):
    """A span on the host clock, `start` and `end` in the trace's
    seconds."""
    return Span(name, parent, round((HOST0 + start) * 1e9),
                round((HOST0 + end) * 1e9), counts, device_ms)


def _spans(step_end=6.0):
    """One traced LEAF step: the loop's prepare, the step's phases, the
    next pull from the loader; the prepare and the step 0.5 s after their
    ranges' starts on the host clock."""
    e = program.ENQUEUE
    return [
        _span("train.fused.prepare", None, 0.5, 1.4),             # 0
        _span("train.fused.step", None, 2.5, step_end + 0.5),      # 1
        _span(e + "phase1", 1, 2.6, 2.8, slots=100, own_tokens=20),  # 2
        _span("train.fused.wait", 1, 2.8, 3.5, early=1),           # 3
        _span("train.fused.candidates", 1, 3.5, 4.0),              # 4
        _span(e + "score", 1, 4.0, 4.2, slots=100, own_tokens=30),   # 5
        _span(e + "update", 1, 4.5, 6.0, slots=10, own_tokens=5),    # 6
        _span(program.OPTIM, 6, 5.0, 5.5, device_ms=3.0),         # 7
        _span("train.loop.next_batch", None, 6.6, 6.8),            # 8
    ]


def _trace(ranges=None, job="leaf"):
    kernels = [("k", 0.0, 1.5), ("k", 1.7, 2.2), ("k", 2.25, 3.1),
               ("k", 3.3, 4.2), ("k", 4.4, 6.15), ("k", 6.2, 8.0),
               ("k", 9.0, 10.0)]
    if ranges is None:
        ranges = [(WINDOW, 0.0, 10.0), ("leaf.prepare_probes", 0.0, 1.0),
                  ("leaf.step", 2.0, 6.0)]
    return Trace(job=job, steps=2, window_s=10.0,
                 busy_s=arith.busy_s(kernels), kernels=kernels,
                 ranges=ranges, work=[], counters={})


@pytest.fixture
def recorded(monkeypatch):
    """Hands the readers made-up spans in place of the program's."""
    box = {"spans": _spans()}
    monkeypatch.setattr(program, "recorded", lambda: box["spans"])
    return box


def test_roots_take_their_ranges_start_and_the_rest_follow():
    where = program.placed(_trace(), _spans())
    want = [(0.0, 0.9), (2.0, 6.0), (2.1, 2.3), (2.3, 3.0), (3.0, 3.5),
            (3.5, 3.7), (4.0, 5.5), (4.5, 5.0), (6.1, 6.3)]
    assert where == [pytest.approx(w) for w in want]


def test_idle_time_goes_to_the_innermost_open_span():
    split = program.idle_by_span(_trace(), _spans())
    # idle: 1.5-1.7 under nothing (the prepare ended at 0.9), 2.2-2.25
    # phase 1, 3.1-3.3 the candidates, 4.2-4.4 the update (its optimizer
    # opened at 4.5), 6.15-6.2 the loader (placed 6.1-6.3), 8-9 nothing
    assert split == {None: pytest.approx(1.2), 2: pytest.approx(0.05),
                     4: pytest.approx(0.2), 6: pytest.approx(0.2),
                     8: pytest.approx(0.05)}
    assert sum(split.values()) == pytest.approx(
        10.0 - _trace().busy_s)


def test_readers_by_hand(tiny_root, recorded):
    spec = Spec(tiny_root)
    t = _trace()
    # per step of 2: grid idle 0.2 s, dispatch idle 0.05 + 0.2 s
    assert spec.reader("idle_grid_ms.leaf")(t) == pytest.approx(100.0)
    assert spec.reader("idle_dispatch_ms.leaf")(t) == pytest.approx(125.0)
    assert spec.reader("wait_ms.leaf")(t) == pytest.approx(350.0)
    # self time: 0.2 + 0.2 + (1.5 - 0.5) s
    assert spec.reader("dispatch_ms.leaf")(t) == pytest.approx(700.0)
    assert spec.reader("pad_share.leaf")(t) == pytest.approx(
        100.0 * (1 - 55 / 210))
    assert spec.reader("optim_ms.leaf")(t) == pytest.approx(1.5)
    assert spec.reader("optim_ms.fare")(t) is None
    assert spec.reader("optim_ms.fare")(_trace(job="fare")) == \
        pytest.approx(1.5)
    for name in ("wait_ms.leaf", "pad_share.leaf", "idle_grid_ms.leaf"):
        assert spec.reader(name)(_trace(job="fare")) is None


def test_nothing_where_the_clocks_do_not_line_up(tiny_root, recorded):
    spec = Spec(tiny_root)
    idle = ("idle_grid_ms.leaf", "idle_dispatch_ms.leaf")
    # a root without its range
    lacking = _trace(ranges=[(WINDOW, 0.0, 10.0), ("leaf.step", 2.0, 6.0)])
    assert program.placed(lacking, _spans()) is None
    assert all(spec.reader(m)(lacking) is None for m in idle)
    # a root that ends past its range: by more than the slack, and within
    recorded["spans"] = _spans(step_end=6.0 + 2 * program.SLACK_S)
    assert all(spec.reader(m)(_trace()) is None for m in idle)
    recorded["spans"] = _spans(step_end=6.0 + program.SLACK_S / 2)
    assert all(spec.reader(m)(_trace()) is not None for m in idle)
    # the counts need no clock
    assert spec.reader("pad_share.leaf")(lacking) is not None


def test_a_program_without_spans_gives_nothing(tiny_root, monkeypatch):
    spec = Spec(tiny_root)
    # the parent's checkout: no tracing module
    import leaf_tpu_torch.utils
    monkeypatch.delattr(leaf_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "leaf_tpu_torch.utils.tracing", None)
    assert program.recorded() is None
    for m in ("wait_ms.leaf", "dispatch_ms.leaf", "idle_dispatch_ms.leaf",
              "idle_grid_ms.leaf", "pad_share.leaf", "optim_ms.leaf"):
        assert spec.reader(m)(_trace()) is None
    assert spec.reader("optim_ms.fare")(_trace(job="fare")) is None
