"""Runs one cell once and assembles its result line.

Everything is found by name from `BENCHMARK.json` at the checkout's root:
the cell's configuration file (its `file`), its traffic mix
(`portbench/traffic/<traffic>.json`, whose `job` names the module of
`portbench/jobs/` that drives the program), the limits of its compared
numbers (`portbench/limits/<workload>.json`) and each per-layer metric's
reader (`portbench/metrics/<metric>.py`).  A new cell, configuration,
traffic mix or metric is new files and entries; no file here changes.
"""
from __future__ import annotations

import ctypes
import importlib
import importlib.util
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from portbench.jobs.common import Cell

GIB = float(1 << 30)


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


class Spec:
    """`BENCHMARK.json` and the files it names."""

    def __init__(self, root: str):
        self.root = root
        self.bench = load_json(root, "BENCHMARK.json")

    def cell(self, workload: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root, c["file"])
        raise KeyError(f"no configuration named {name!r}")

    def traffic(self, name: str) -> dict:
        return load_json(self.root, "portbench", "traffic", f"{name}.json")

    def limits(self, workload: str) -> Dict[str, dict]:
        return load_json(self.root, "portbench", "limits",
                         f"{workload}.json")["checks"]

    @staticmethod
    def applies(metric: dict, workload: str) -> bool:
        return workload in metric.get("workloads", [workload])

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.applies(m, workload)]

    def per_layer(self, workload: str) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if self.applies(m, workload) and m["moves"] in reported]

    def reader(self, name: str):
        path = os.path.join(self.root, "portbench", "metrics", f"{name}.py")
        mod_spec = importlib.util.spec_from_file_location(
            "portbench.metrics." + name.replace(".", "_"), path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module.read


def power_limit_w(dev: torch.device) -> Optional[float]:
    """The card's enforced power limit in watts, read through NVML (the
    driver's library), which the roofline and MFU shares' peaks assume at
    700 W; None where NVML is absent or does not answer."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    if nvml.nvmlInit_v2() != 0:
        return None
    try:
        props = torch.cuda.get_device_properties(dev)
        handle, milliwatts = ctypes.c_void_p(), ctypes.c_uint()
        if hasattr(props, "pci_bus_id"):
            bus = (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
                   f"{props.pci_device_id:02x}.0").encode()
            rc = nvml.nvmlDeviceGetHandleByPciBusId_v2(
                ctypes.c_char_p(bus), ctypes.byref(handle))
        else:
            rc = nvml.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(dev.index or 0), ctypes.byref(handle))
        if rc != 0 or nvml.nvmlDeviceGetEnforcedPowerLimit(
                handle, ctypes.byref(milliwatts)) != 0:
            return None
        return milliwatts.value / 1000.0
    finally:
        nvml.nvmlShutdown()


def device_info(device, peak: int, trace=None) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": peak}
    if dev.type == "cuda":
        info["power_limit_w"] = power_limit_w(dev)
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float
             ) -> Tuple[dict, List[str]]:
    """One run: (the result's object, the compared numbers' lines)."""
    spec = Spec(root)
    entry = spec.cell(workload)
    traffic = spec.traffic(entry["traffic"])
    limits = spec.limits(workload)
    job_module = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    cell = Cell(workload=workload, config=spec.config(entry["config"]),
                traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                device=torch.device(device), t_start=t_start)
    job = job_module.Job(cell)
    outcome = job.run()
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    traced = job.trace() if trace else None
    numbers = job.check()
    checks = {name: {"value": numbers[name], "limit": lim["limit"]}
              for name, lim in limits.items()}
    correct = (not outcome.raised
               and all(c["value"] <= c["limit"] for c in checks.values()))

    values = {"setup_s": outcome.setup_s, "peak_mem_gib": peak / GIB,
              traffic["rate_metric"]: outcome.units / outcome.window_s}
    metrics = {}
    if traced is None:
        for m in spec.end_to_end(workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in spec.per_layer(workload):
            value = spec.reader(m["name"])(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_info(cell.device, peak, traced)}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    lines = ["set-up, s from the start to the end of each part: " + ", ".join(
        f"{k} {v:.3f}" for k, v in outcome.phases.items())]
    lines += [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
              for name, c in checks.items()]
    return result, lines


def loaded_jax(modules) -> Optional[List[str]]:
    """Top-level names of `modules` that are JAX's or the JAX package's,
    compared whole."""
    banned = {"jax", "jaxlib", "flax", "leaf_tpu"}
    found = sorted({m.split(".")[0] for m in modules} & banned)
    return found or None
