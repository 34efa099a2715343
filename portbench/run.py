"""Run one cell of the benchmark of `leaf_tpu_torch` once:

    python3 -m portbench.run --workload leaf.ctx77 --seed 7 \\
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  It loads, warms up, measures for `--seconds`, judges the timed
path's output against the plain reference, prints each compared number
beside its limit on standard error and, last on standard output, one JSON
line: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` `breakdown`, and last `checks`.  It exits non-zero and prints
no result without the cards, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser("portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    # the program's build and kernel caches stay in the checkout, at fixed
    # paths, so that only a cell's first run there builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, ".cache", sub)
    os.environ["USE_FLAX"] = "0"
    # one process with one thread of each math library: the program's host
    # work is single-threaded, and idle workers only add noise
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch
    from portbench.harness import Spec, loaded_jax, run_cell
    chips = Spec(root).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_START)
    found = loaded_jax(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
