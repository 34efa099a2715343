"""What the harness hands a job, and what a job hands back."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class Cell:
    """One run of one cell: its configuration and traffic files' contents,
    the run's seed, window and device."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float          # host clock at the process's start


@dataclasses.dataclass
class Outcome:
    """The window as a job measured it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0          # captions or images trained in the window
    attempted: int = 0      # optimizer steps begun in the window
    failed: int = 0         # of those, raised or gave a non-finite loss
    raised: bool = False
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    # host seconds from the process's start to the end of each set-up part
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
