"""Fixtures of the benchmark's own tests (`python -m pytest portbench/`).

`tiny_root` is a checkout of the benchmark with one more configuration
pair, two more traffic mixes, two more cells and one more per-layer metric,
added as files and entries alone: ViT-tiny-test's towers on the CPU,
where the program runs its plain versions.  Tests marked `card` need an
NVIDIA card and skip without one; the card is looked for inside the
`card` fixture, never at import.
"""
from __future__ import annotations

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_TEXT = {
    "registry": "ViT-tiny-test", "embed_dim": 64, "quick_gelu": False,
    "vision_cfg": {"image_size": 64, "layers": 0, "width": 64,
                   "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64,
                 "heads": 2, "layers": 2},
    "published_layers": 2, "compute_dtype": "bfloat16"}
TINY_VISION = {
    "registry": "ViT-tiny-test", "embed_dim": 64, "quick_gelu": False,
    "vision_cfg": {"image_size": 64, "layers": 2, "width": 64,
                   "head_width": 32, "patch_size": 16},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64,
                 "heads": 2, "layers": 0},
    "published_layers": 2, "compute_dtype": "bfloat16", "qkv_gain": 2.0}
# the fixture cells' limits, from CPU runs of them on six seeds (the
# tiny towers' bf16 rounding weighs more than the full ones' on the card)
TINY_LEAF_LIMITS = {"anchor_err": 0.06, "probe_gap": 0.03, "cand_gap": 0.2,
                    "loss_err": 0.01, "grad_leaf": 0.025, "delta_leaf": 0.04}
TINY_FARE_LIMITS = {"anchor_err": 0.08, "ball_excess": 2.4e-07,
                    "attack_gap": 0.4, "loss_err": 0.1, "grad_leaf": 0.5,
                    "delta_leaf": 0.06}
FIXTURE_METRIC = '''"""steps_traced.fixture: the traced steps (a fixture)."""


def read(trace):
    return float(trace.steps) if trace.steps else None
'''


def _write(path, obj):
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f, indent=1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(REPO, "portbench", sub),
                        os.path.join(root, "portbench", sub))
    pb = os.path.join(root, "portbench")
    _write(os.path.join(pb, "configs", "ViT-tiny-test.text.json"), TINY_TEXT)
    _write(os.path.join(pb, "configs", "ViT-tiny-test.vision.json"),
           TINY_VISION)
    with open(os.path.join(pb, "traffic", "short.json")) as f:
        leaf = json.load(f)
    leaf.update(batch=8, rho=6, pool_batches=4, trace_steps=2,
                bucket_shares={"16": 0.5, "32": 0.5})
    leaf["captions"]["word_count"] = {"law": "uniform", "min": 2, "max": 20}
    _write(os.path.join(pb, "traffic", "tiny-mix.json"), leaf)
    with open(os.path.join(pb, "traffic", "pgd10.json")) as f:
        fare = json.load(f)
    fare.update(batch=4, image_size=64, pool_batches=4, iterations=2,
                trace_steps=2)
    _write(os.path.join(pb, "traffic", "tiny-pgd.json"), fare)
    _write(os.path.join(pb, "limits", "tiny.leaf.json"),
           {"checks": {k: {"limit": v} for k, v in TINY_LEAF_LIMITS.items()}})
    _write(os.path.join(pb, "limits", "tiny.fare.json"),
           {"checks": {k: {"limit": v} for k, v in TINY_FARE_LIMITS.items()}})
    _write(os.path.join(pb, "metrics", "steps_traced.fixture.py"),
           FIXTURE_METRIC)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] += [
        {"name": "ViT-tiny-test.text", "source": "a test fixture",
         "file": "portbench/configs/ViT-tiny-test.text.json", "reduced": [],
         "why": "the tiny text tower"},
        {"name": "ViT-tiny-test.vision", "source": "a test fixture",
         "file": "portbench/configs/ViT-tiny-test.vision.json",
         "reduced": [], "why": "the tiny vision tower"}]
    bench["workloads"] += [
        {"name": "tiny.leaf", "config": "ViT-tiny-test.text",
         "traffic": "tiny-mix", "chips": 1, "why": "a test fixture"},
        {"name": "tiny.fare", "config": "ViT-tiny-test.vision",
         "traffic": "tiny-pgd", "chips": 1, "why": "a test fixture"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            tiny = ("tiny.leaf" if any(w.startswith("leaf")
                                       for w in m["workloads"])
                    else "tiny.fare")
            m["workloads"].append(tiny)
    bench["per_layer"].append(
        {"name": "steps_traced.fixture", "unit": "steps", "better": "higher",
         "source": "device_trace", "layer": "whole step",
         "moves": "leaf_samples_per_s", "workloads": ["tiny.leaf"]})
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip machine)")
    return torch.device("cuda", 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: a test that needs an NVIDIA card; it skips on a "
                   "machine without one")
