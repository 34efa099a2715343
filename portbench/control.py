"""Readings that the limits of a cell's compared numbers are set from (the
benchmark's own runs do not run this):

    python3 -m portbench.control --workload leaf.ctx77 \\
        --seeds 11 12 13 ... --stand-in-seeds 3 --out control.jsonl

For each seed, one process builds the cell as a run does, drives its
checked steps (no window) and judges the program; on the first
`--stand-in-seeds` seeds it also puts the reference in the program's place
in fp8 (the control) and with each planted fault ("half": half of the
batch left out, the mean taken over the rest; "token": the answer altered
where it is produced), and judges those the same way.  A state left
unchanged reads 1 on `delta_leaf` and needs no run.  One JSON line a
reading: {"seed", "who", "numbers"}.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

VARIANTS = (("fp8", True, None), ("half", False, "half"),
            ("token", False, "token"))


def readings(root: str, workload: str, seeds, stand_in_seeds: int, device,
             out):
    import torch
    from portbench.harness import Spec
    from portbench.jobs.common import Cell
    spec = Spec(root)
    entry = spec.cell(workload)
    traffic = spec.traffic(entry["traffic"])
    job_module = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    for n, seed in enumerate(seeds):
        cell = Cell(workload=workload, config=spec.config(entry["config"]),
                    traffic=traffic, seed=seed, seconds=0.0, trace=False,
                    device=torch.device(device), t_start=time.perf_counter())
        job = job_module.Job(cell)
        job.run()
        rows = [("program", job.check())]
        if n < stand_in_seeds:
            rows += [(who, job.stand_in(fp8, fault))
                     for who, fp8, fault in VARIANTS]
        for who, numbers in rows:
            line = json.dumps({"workload": workload, "seed": seed,
                               "who": who, "numbers": numbers})
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
        del job
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.control")
    p.add_argument("--workload", required=True, action="append")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--stand-in-seeds", type=int, default=3)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for workload in args.workload:
            readings(os.getcwd(), workload, args.seeds, args.stand_in_seeds,
                     args.device, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
