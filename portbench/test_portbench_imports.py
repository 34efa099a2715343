"""What a run loads: never JAX or the JAX package (top-level names
compared whole: the program's name begins with the JAX package's), never
the older benchmark scripts or the program's profiling modules; and the
reference loads nothing of the program."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.harness import loaded_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_names_are_compared_whole():
    assert loaded_jax(["leaf_tpu_torch", "leaf_tpu_torch.ops.build"]) is None
    assert loaded_jax(["leaf_tpu.ops", "numpy"]) == ["leaf_tpu"]
    assert loaded_jax(["jaxlib.xla_client", "flax.linen", "jax"]) == [
        "flax", "jax", "jaxlib"]


def _loaded(code: str, cwd: str = REPO) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=cwd, capture_output=True, text=True, check=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO)).stdout.strip().splitlines()
    return json.loads(out[-1])


def test_the_reference_loads_nothing_of_the_program():
    modules = _loaded("import portbench.reference.clip, "
                      "portbench.reference.text, portbench.reference.leaf, "
                      "portbench.reference.fare")
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {"leaf_tpu_torch", "leaf_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_neither_jax_nor_the_old_benchmark(tiny_root):
    modules = _loaded(
        "import time\n"
        "from portbench.harness import run_cell\n"
        f"run_cell({tiny_root!r}, 'tiny.leaf', 5, 0.5, False, 'cpu', "
        "time.perf_counter())\n"
        f"run_cell({tiny_root!r}, 'tiny.fare', 5, 0.5, False, 'cpu', "
        "time.perf_counter())", cwd=tiny_root)
    assert "leaf_tpu_torch.train.fused" in modules
    assert loaded_jax(modules) is None
    assert not [m for m in modules
                if m.split(".")[0] in ("bench", "chip_smoke")
                or m.startswith("leaf_tpu_torch.profile_")]
