"""Digests of the tiny text tower's CPU forward, each in a fresh process.

    python -m leaf_tpu_torch.cpu_digests --processes 600 --workers 4

runs the text tower of ViT-tiny-test (fp32, weights from seed 0, a seeded
batch of ids) in that many fresh interpreter processes at PyTorch's default
thread count, and once on one thread, and prints one JSON line: how many
processes' output bytes differ from the one-thread run's.  The CPU tests
hold the port to the JAX package through this forward; a library's vector
math whose first call in a process splits over threads and returns another
result on one of them (an MKL square root did, in AdamW's CPU update:
`train/optim.py::adamw_kwargs`) would show here as a differing digest.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

MODEL = "ViT-tiny-test"
BATCH = 16


def digest(threads: int) -> str:
    """sha256 of the text features' bytes; `threads` 0: the default."""
    import numpy as np
    import torch
    if threads:
        torch.set_num_threads(threads)
    from leaf_tpu_torch.models.factory import create_model
    model = create_model(MODEL, precision="fp32", seed=0, device="cpu")
    cfg = model.cfg.text
    ids = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (BATCH, cfg.context_length))
    with torch.no_grad():
        out = model.encode_text(torch.from_numpy(ids))
    return hashlib.sha256(out.numpy().tobytes()).hexdigest()


def _child(threads: int) -> str:
    cmd = [sys.executable, "-m", "leaf_tpu_torch.cpu_digests", "--child",
           "--threads", str(threads)]
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=600)
    ap.add_argument("--workers", type=int, default=4,
                    help="processes running at once")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--threads", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(digest(args.threads))
        return 0
    want = _child(1)
    with ThreadPoolExecutor(args.workers) as pool:
        got = list(pool.map(_child, [0] * args.processes))
    differ = sum(d != want for d in got)
    print(json.dumps({"model": MODEL, "processes": args.processes,
                      "differ": differ, "distinct": len(set(got)),
                      "one_thread": want}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
