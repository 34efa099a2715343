"""A whole run of each fixture cell on the CPU, as `portbench.run` makes it
on the card, and the run's refusals."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness import Spec, run_cell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 11


@pytest.mark.parametrize("workload", ["tiny.leaf", "tiny.fare"])
def test_a_tiny_run_gives_a_well_formed_result(tiny_root, workload):
    result, lines = run_cell(tiny_root, workload, SEED, 1.0, False, "cpu",
                             time.perf_counter())
    back = json.loads(json.dumps(result))
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True
    assert back["attempted"] > 0 and back["failed"] == 0
    wanted = Spec(tiny_root).end_to_end(workload)
    assert set(back["metrics"]) == {m["name"] for m in wanted}
    for m in wanted:
        assert back["metrics"][m["name"]]["unit"] == m["unit"]
        assert back["metrics"][m["name"]]["value"] >= 0
    assert back["metrics"]["setup_s"]["value"] > 0
    assert back["device"]["count"] == 1
    for name, check in back["checks"].items():
        assert check["value"] <= check["limit"], name
    assert lines[-len(back["checks"]):] == [
        f"check {k}: {c['value']!r} (limit {c['limit']!r})"
        for k, c in result["checks"].items()]


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=600)


def test_without_a_card_the_run_prints_no_result(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = _run(tiny_root, "--workload", "tiny.leaf", "--seed", "1",
                "--seconds", "1", "--trace", "0", env=env)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_the_benchmark_alone_refuses_to_run(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only: no
    program to measure."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run(str(tmp_path), "--workload", "leaf.ctx77", "--seed", "1",
                "--seconds", "1", "--trace", "0", env=env)
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.card
def test_the_card_gives_its_power_limit(card):
    from portbench.harness import device_info
    info = device_info(card, 0)
    assert info["platform"] == "gpu"
    assert 100.0 <= info["power_limit_w"] <= 1000.0
