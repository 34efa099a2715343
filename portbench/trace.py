"""The traced run: `torch.profiler` over whole steps at the start of the
window, reduced to what the per-layer metrics read (the device's kernel
intervals, the benchmark's own host ranges) and to the run's `breakdown`.

The ranges are the benchmark's: each job opens them around its calls into
the program (`leaf.prepare_probes`, `leaf.step`, `fare.anchors`,
`fare.attack`, `fare.update`), and `portbench.window` spans the profiled
steps.  An idle gap of the device is labelled by the innermost range open
on the host at its middle, `<job>.loop` where none is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.metrics.arith import busy_s

WINDOW = "portbench.window"
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    job: str
    steps: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # (name, start s, end s)
    ranges: List[Tuple[str, float, float]]
    work: list                                 # arith.Encode of the steps
    counters: Dict[str, float]

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for name, start, end in self.kernels:
            by_name[name[:NAME_CHARS]] = by_name.get(name[:NAME_CHARS], 0.0) \
                + end - start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.idle_by_range()[:10]]}

    def idle_by_range(self) -> List[Tuple[str, float]]:
        """Idle seconds of the device inside the window, summed by the
        host range open at each gap's middle, longest first."""
        window = [r for r in self.ranges if r[0] == WINDOW]
        if not window:
            return []
        lo, hi = window[0][1], window[0][2]
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        edges = [lo] + [x for m in merged for x in m] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
        named = [r for r in self.ranges if r[0] != WINDOW]
        out: Dict[str, float] = {}
        for s, e in gaps:
            if e <= s:
                continue
            mid = (s + e) / 2
            inside = [r for r in named if r[1] <= mid < r[2]]
            label = (max(inside, key=lambda r: r[1])[0] if inside
                     else f"{self.job}.loop")
            out[label] = out.get(label, 0.0) + e - s
        return sorted(out.items(), key=lambda kv: -kv[1])


class Capture:
    """The profiler, opened and closed by the job's feed around whole
    steps; the device is synchronised at both ends."""

    def __init__(self):
        self.prof = None
        self.window = None
        self.seconds = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def reduce(self, job: str, steps: int, work: list,
               counters: Dict[str, float], labels) -> Trace:
        from torch.autograd import DeviceType
        kernels, ranges = [], []
        for e in self.prof.events():
            start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.name == WINDOW or e.name in labels:
                # a range shows twice: on the host, and as the device's
                # annotation of the kernels it launched
                if e.device_type == DeviceType.CPU:
                    ranges.append((e.name, start, end))
            elif (e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)):
                # the device's operations; an annotation (the program's or
                # PyTorch's own ranges, such as the optimizer's step) only
                # spans some of them
                kernels.append((e.name, start, end))
        if not kernels:
            raise RuntimeError("the profiler recorded no device operation")
        window = [r for r in ranges if r[0] == WINDOW]
        window_s = (window[0][2] - window[0][1]) if window else self.seconds
        return Trace(job=job, steps=steps, window_s=window_s,
                     busy_s=busy_s(kernels), kernels=kernels, ranges=ranges,
                     work=work, counters=counters)


class Range:
    """A named host range that may open and close in different frames
    (None where the run is not traced)."""

    def __init__(self, capture: Optional[Capture]):
        self.capture = capture
        self.open = None

    def enter(self, name: str) -> None:
        if self.capture is not None and self.capture.prof is not None:
            self.open = torch.profiler.record_function(name)
            self.open.__enter__()

    def exit(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

