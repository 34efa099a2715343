"""The control: the reference in the program's place, computed in fp8 (the
step below the configurations' bf16), has to come out not correct; and so
has each planted fault.  On the CPU at the fixture cells' size; with a card
at the cells' own size, on three seeds, with their limits."""
from __future__ import annotations

import importlib
import os
import time

import pytest
import torch

from portbench.harness import Spec
from portbench.jobs.common import Cell


def _job(root, workload, seed, device):
    spec = Spec(root)
    entry = spec.cell(workload)
    traffic = spec.traffic(entry["traffic"])
    module = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    job = module.Job(Cell(workload=workload,
                          config=spec.config(entry["config"]),
                          traffic=traffic, seed=seed, seconds=0.0, trace=False,
                          device=torch.device(device),
                          t_start=time.perf_counter()))
    job.run()
    return job, spec.limits(workload)


def _fails(numbers, limits) -> bool:
    return any(numbers[k] > v["limit"] for k, v in limits.items())


@pytest.mark.parametrize("workload", ["tiny.leaf", "tiny.fare"])
def test_the_control_and_the_faults_fail_on_the_cpu(tiny_root, workload):
    job, limits = _job(tiny_root, workload, 2 ** 31 + 1, "cpu")
    assert not _fails(job.check(), limits)
    for fp8, fault in ((True, None), (False, "half"), (False, "token")):
        assert _fails(job.stand_in(fp8, fault), limits), (fp8, fault)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["leaf.ctx77", "leaf.short",
                                      "fare.pgd10"])
def test_the_control_fails_at_the_cells_size(card, workload):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for seed in (2 ** 31 + 101, 2 ** 31 + 103, 2 ** 31 + 105):
        job, limits = _job(root, workload, seed, card)
        assert not _fails(job.check(), limits)
        for fp8, fault in ((True, None), (False, "half"), (False, "token")):
            assert _fails(job.stand_in(fp8, fault), limits), (fp8, fault)
        del job
        torch.cuda.empty_cache()
