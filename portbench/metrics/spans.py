"""The program's spans (`leaf_tpu_torch.utils.tracing`) over the traced
steps, put on the trace's clock, and the device's idle time split among
them; shared by the per-layer metrics that read spans.

The job's `Capture` is the run's only profiler session, and no program
step runs after it, so the spans that `tracing.recorded()` gives after the
run are the traced steps'.  They carry the host's clock
(`time.perf_counter_ns`), the trace the profiler's.  Each root span of a
traced step is put at the start of the benchmark range that encloses it,
the k-th root of a name at the k-th range of its name: `leaf.step`
encloses `train.fused.step`, `leaf.prepare_probes` a `train.fused.prepare`
opened outside a step (the loop's preparation of the next batch).  Every
span opened after a root and before the next takes that root's offset;
spans before the first root take the first's.  Where a root lacks its
range, or ends more than `SLACK_S` past its range's end, the clocks do not
line up: the placement gives None and so do the metrics that need it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from portbench.trace import WINDOW

ROOTS = {"train.fused.step": "leaf.step",
         "train.fused.prepare": "leaf.prepare_probes"}
SLACK_S = 0.05e-3
ENQUEUE = "train.fused.enqueue."
GRID = ("train.fused.prepare", "train.fused.candidates", "train.fused.clean")
OPTIM = "train.optim.update"


def recorded():
    """The program's recorded spans, or None where the program has no
    tracing module (a checkout older than it)."""
    try:
        from leaf_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.recorded()


def placed(trace, spans) -> Optional[List[Tuple[float, float]]]:
    """(start, end) in the trace's seconds of every span, in the spans'
    order, or None where a root lacks its range or overruns it."""
    ranges = {name: sorted((s, e) for n, s, e in trace.ranges if n == name)
              for name in ROOTS.values()}
    roots = [sp for sp in spans if sp.parent is None and sp.name in ROOTS]
    for name, rng in ranges.items():
        if sum(ROOTS[sp.name] == name for sp in roots) != len(rng):
            return None
    if not roots:
        return None
    used = dict.fromkeys(ranges, 0)
    offsets, offset = [], None
    for sp in spans:
        if sp.parent is None and sp.name in ROOTS:
            name = ROOTS[sp.name]
            start, end = ranges[name][used[name]]
            used[name] += 1
            offset = start - sp.start_ns / 1e9
            if sp.end_ns / 1e9 + offset > end + SLACK_S:
                return None
        offsets.append(offset)
    first = next(o for o in offsets if o is not None)
    return [(sp.start_ns / 1e9 + (first if o is None else o),
             sp.end_ns / 1e9 + (first if o is None else o))
            for sp, o in zip(spans, offsets)]


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the window: its complement of
    the union of the kernels' intervals."""
    window = [r for r in trace.ranges if r[0] == WINDOW]
    if not window:
        return []
    lo, hi = window[0][1], window[0][2]
    out, t = [], lo
    for _, s, e in sorted(trace.kernels, key=lambda k: k[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _segments(where: List[Tuple[float, float]]):
    """(start, end, index of the innermost span open, or None) over the
    time the spans cover: the innermost is the latest opened."""
    edges = sorted({t for se in where for t in se})
    out = []
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2
        open_ = [i for i, (s, e) in enumerate(where) if s <= mid < e]
        out.append((a, b, max(open_, key=lambda i: (where[i][0], i))
                    if open_ else None))
    return out


def idle_by_span(trace, spans) -> Optional[Dict[Optional[int], float]]:
    """Idle seconds of the device in the window, by the index of the
    innermost program span open over them (None: no span), or None where
    the spans cannot be placed."""
    where = placed(trace, spans)
    if where is None:
        return None
    out: Dict[Optional[int], float] = {}
    segs = _segments(where)
    k = 0
    for s, e in idle_intervals(trace):
        # the parts of [s, e) outside every segment belong to no span
        covered = 0.0
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < e:
            a, b = max(s, segs[j][0]), min(e, segs[j][1])
            if b > a:
                out[segs[j][2]] = out.get(segs[j][2], 0.0) + b - a
                covered += b - a
            j += 1
        if e - s > covered:
            out[None] = out.get(None, 0.0) + (e - s) - covered
    return out


def under(spans, i: Optional[int], test: Callable[[str], bool]) -> bool:
    """Whether span i or a span it opened inside passes `test`."""
    while i is not None:
        if test(spans[i].name):
            return True
        i = spans[i].parent
    return False


def idle_ms_under(trace, test: Callable[[str], bool]) -> Optional[float]:
    """Idle ms of the device a traced LEAF step while the innermost open
    span passes `test` or opened inside one that does."""
    spans = recorded()
    if trace.job != "leaf" or not trace.steps or not spans:
        return None
    split = idle_by_span(trace, spans)
    if split is None:
        return None
    s = sum(v for i, v in split.items() if under(spans, i, test))
    return 1e3 * s / trace.steps


def leaf_spans(trace):
    """The recorded spans where the trace is a LEAF run's with steps."""
    if trace.job != "leaf" or not trace.steps:
        return None
    return recorded() or None


def optim_ms(trace, job: str) -> Optional[float]:
    """Device ms of the optimizer's updates a traced step of `job`."""
    spans = recorded()
    if trace.job != job or not trace.steps or not spans:
        return None
    times = [s.device_ms for s in spans if s.name == OPTIM]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / trace.steps
