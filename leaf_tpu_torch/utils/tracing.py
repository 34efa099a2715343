"""The port's spans and counts, and the trainers' `--profile-dir` trace
window.

A span marks one piece of a layer's work on the host:

    with tracing.span("train.fused.enqueue.score", slots=n) as s:
        ...
    if s:                           # false while nothing records
        s.add("own_tokens", k)

It records its name, the span it opened inside, the host clock at open and
close (`time.perf_counter_ns`) and integer counts given at open or added
with `add` (a count may also be a function of no argument, called when the
recording is read, for a value the device still computes).  With
`device=True` it also records a CUDA event on the current stream at open
and at close, where CUDA is in use: the device's time from the span's first
enqueued work to its last.

Spans are kept only while a recording is on: while a `torch.profiler`
session records, or inside `recording()`.  Under the profiler each span
also opens `torch.profiler.record_function(name)`, so that a profiler's
trace (the trainers' `--profile-dir` included) shows the program's spans
above the kernels they launched.  With no recording on, `span()` checks one
flag and asks the profiler whether it records, and returns a shared object
that does nothing: it reads no clock, records no event and keeps nothing.

`recorded()` gives the spans of the last recording that closed inside it,
in the order they opened.  A new recording clears the previous one; a new
profiler session is seen as new when a span opens, so that a span opened
between two sessions keeps them apart.  A span open when a recording starts
or stops is closed as usual and left out of it.  `TraceWindow`, whose
trace has no reader of `recorded()`, drops its recording when it closes.

Names carry the port's module path (`train.fused.*`, `train.loop.*`,
`train.optim.*`); none starts with a name that the
benchmark gives its own ranges (`leaf.`, `fare.`, `portbench.`).  Spans are
opened and closed on the thread that drives the trainer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Union

import torch

_profiler_enabled = torch.autograd._profiler_enabled

Count = Union[int, Callable[[], int]]


@dataclasses.dataclass
class Span:
    """One span of a recording.  `parent` is the index in `recorded()` of
    the recorded span it opened inside (None for a root); `device_ms` is
    None where no device events were recorded."""
    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: int
    counts: Dict[str, int]
    device_ms: Optional[float]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Recorder:
    """The process's recording: the spans opened since it began, and the
    stack of those still open."""

    def __init__(self):
        self.explicit = 0       # `recording()` blocks open
        self.live = False       # a recording under the profiler goes on
        self.generation = 0
        self.spans: List[_Open] = []
        self.stack: List[_Open] = []

    def begin(self) -> None:
        self.generation += 1
        self.spans, self.stack = [], []


_RECORDER = _Recorder()


class _Off:
    """The span of no recording."""

    def __bool__(self) -> bool:
        return False

    def add(self, key: str, n: Count) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Open:
    """A span while a recording is on."""

    def __init__(self, name: str, device: bool, counts: Dict[str, Count],
                 profiled: bool):
        self.name = name
        self.device = device
        self.counts = counts
        self.profiled = profiled
        self.parent: Optional[_Open] = None
        self.start_ns = self.end_ns = 0
        self.closed = self.kept = False
        self.events = None
        self.device_ms: Optional[float] = None
        self._range = None

    def add(self, key: str, n: Count) -> None:
        old = self.counts.get(key, 0)
        if callable(old) or callable(n):
            self.counts[key] = lambda a=old, b=n: _value(a) + _value(b)
        else:
            self.counts[key] = old + n

    def __enter__(self) -> "_Open":
        rec = _RECORDER
        if not rec.explicit and not rec.live:
            # the first span of a profiler session
            rec.begin()
            rec.live = True
        self.generation = rec.generation
        self.parent = rec.stack[-1] if rec.stack else None
        rec.stack.append(self)
        rec.spans.append(self)
        if self.profiled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        rec = _RECORDER
        if rec.stack and rec.stack[-1] is self:
            rec.stack.pop()
        elif self in rec.stack:
            rec.stack.remove(self)
        self.closed = True
        on = bool(rec.explicit) or _profiler_enabled()
        self.kept = self.generation == rec.generation and on
        if not on:
            rec.live = False
        return None


def _value(n: Count) -> int:
    return int(n()) if callable(n) else int(n)


def span(name: str, device: bool = False, **counts: Count):
    """A context manager for one span of the program's work (the module
    docstring); falsy, and doing nothing, while no recording is on."""
    profiled = _profiler_enabled()
    if _RECORDER.explicit or profiled:
        return _Open(name, device, counts, profiled)
    _RECORDER.live = False
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not; `recorded()` gives
    them after it."""
    rec = _RECORDER
    if not rec.explicit:
        rec.begin()
    rec.explicit += 1
    try:
        yield
    finally:
        rec.explicit -= 1
        if not rec.explicit:
            rec.live = False


def recorded() -> List[Span]:
    """The spans of the last recording that closed inside it, in the order
    they opened, with their counts and device times (which waits for the
    device where a span recorded events)."""
    kept = [s for s in _RECORDER.spans if s.closed and s.kept]
    index = {id(s): i for i, s in enumerate(kept)}
    out = []
    for s in kept:
        parent = s.parent
        while parent is not None and id(parent) not in index:
            parent = parent.parent
        # resolved once: a later read finds plain numbers, and the tensors
        # a count read from are let go
        s.counts = {k: _value(v) for k, v in s.counts.items()}
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
        out.append(Span(s.name, None if parent is None else index[id(parent)],
                        s.start_ns, s.end_ns, dict(s.counts), s.device_ms))
    return out


class TraceWindow:
    """`--profile-dir`: a `torch.profiler` trace of batches 2 to 5 of
    epoch 0 (past the first batches' kernel builds and warm-up), written
    as a Chrome trace `trace_epoch0_batches2-5.json` into the directory;
    the program's spans show in it as ranges.  Call `step(i)` before batch
    i and `close()` after the loop, which ends a window that the epoch cut
    short."""

    def __init__(self, profile_dir: Optional[str], epoch: int,
                 first: int = 2, stop: int = 6):
        self.dir = profile_dir if profile_dir and epoch == 0 else None
        self.first, self.stop = first, stop
        self.prof = None
        self.last = first     # the last batch index inside the window

    def step(self, i: int) -> None:
        if self.dir is None:
            return
        if i == self.first and self.prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif self.prof is not None:
            if i == self.stop:
                self.close()
            else:
                self.last = i

    def close(self) -> Optional[str]:
        if self.prof is None:
            return None
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_epoch0_batches{self.first}-"
                                      f"{self.last}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        if not _RECORDER.explicit:
            # the spans, and the values their counts hold, are let go
            _RECORDER.begin()
            _RECORDER.live = False
        return path
