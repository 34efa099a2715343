"""Model profiler: parameters, operations and bytes of both encoders
(port of `leaf_tpu/utils/profiler.py`), and the trainers' `--profile-dir`
trace window.

    python -m leaf_tpu_torch.utils.profiler --model ViT-B-32 [--results out.csv]

`profile_model` runs one forward of each tower at batch `batch_size` on
seeded random weights (the counts do not depend on them) and counts:

  * `mparams*`: parameters, in millions (the JAX package's count);
  * `gflops_*`: `torch.utils.flop_counter.FlopCounterMode`'s operations,
    2 a multiply-add, of the matrix products.  On a card the three hand
    ops run as the custom ops `torch.ops.leaf_tpu_torch.*`
    (`ops.packed_attention.dispatcher`), whose registered formulas count
    what each op's plain version computes; on the CPU the plain versions
    run and their products are counted directly, so both give the same
    number.  XLA's `cost_analysis` also counts elementwise work
    (softmax, LayerNorm, GELU, bias adds), which `FlopCounterMode` does
    not: the JAX package's figures are higher by that share;
  * `gbytes_*`: the bytes of every op's inputs and outputs, summed over
    the ops `torch.__torch_dispatch__` sees (a custom op counts as one op),
    under a `TorchDispatchMode`.  It is no counterpart of XLA's "bytes
    accessed", which counts the fused program's memory traffic; it is an
    upper bound of the unfused traffic.
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from leaf_tpu_torch.models.config import list_models


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def _count(fn, *args):
    """(operations, bytes) of one call of `fn`."""
    flops, nbytes = FlopCounterMode(display=False), _BytesMode()
    with torch.inference_mode(), flops, nbytes:
        fn(*args)
    return flops.get_total_flops(), nbytes.bytes


def _params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def profile_model(model_name: str, batch_size: int = 1,
                  precision: str = "fp32", device="cpu") -> Dict[str, float]:
    """One row of the profile (see the module docstring) for a registry
    model, on `device`."""
    if "coca" in model_name.lower():
        raise NotImplementedError(
            f"{model_name}: CoCa models are not ported to leaf_tpu_torch yet: "
            "ROADMAP Queue 1 item 11")
    from leaf_tpu_torch.models.factory import create_model
    from leaf_tpu_torch.ops import packed_attention as ops

    model = create_model(model_name, precision=precision, seed=0,
                         device=device)
    cfg, module = model.cfg, model.module
    tokens = torch.zeros((batch_size, cfg.text.context_length),
                         dtype=torch.int32, device=model.device)
    tokens[:, 0], tokens[:, 1] = 49406, 49407
    size = cfg.vision.image_size
    images = torch.zeros((batch_size, size, size, 3), dtype=model.dtype,
                         device=model.device)
    route = ops.dispatcher() if model.device.type == "cuda" \
        else contextlib.nullcontext()
    with route:
        img_flops, img_bytes = _count(module.encode_image, images)
        txt_flops, txt_bytes = _count(module.encode_text, tokens)
    return {
        "model": model_name,
        "image_size": size,
        "image_width": cfg.vision.width,
        "text_width": cfg.text.width,
        "embed_dim": cfg.embed_dim,
        "mparams": _params(module) / 1e6,
        "mparams_image": _params(module.visual) / 1e6,
        "mparams_text": _params(module.text) / 1e6,
        "gflops_image": img_flops / 1e9,
        "gflops_text": txt_flops / 1e9,
        "gbytes_image": img_bytes / 1e9,
        "gbytes_text": txt_bytes / 1e9,
    }


class TraceWindow:
    """`--profile-dir`: a `torch.profiler` trace of batches 2 to 5 of
    epoch 0 (past the first batches' kernel builds and warm-up), written
    as a Chrome trace `trace_epoch0_batches2-5.json` into the directory.
    Call `step(i)` before batch i and `close()` after the loop, which
    ends a window that the epoch cut short."""

    def __init__(self, profile_dir: Optional[str], epoch: int,
                 first: int = 2, stop: int = 6):
        self.dir = profile_dir if profile_dir and epoch == 0 else None
        self.first, self.stop = first, stop
        self.prof = None
        self.last = first     # the last batch index inside the window

    def step(self, i: int) -> None:
        if self.dir is None:
            return
        if i == self.first and self.prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif self.prof is not None:
            if i == self.stop:
                self.close()
            else:
                self.last = i

    def close(self) -> Optional[str]:
        if self.prof is None:
            return None
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace_epoch0_batches{self.first}-"
                                      f"{self.last}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        return path


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser("leaf_tpu_torch model profiler")
    p.add_argument("--model", type=str, default="ViT-B-32",
                   help="comma-sep model names, or 'all'")
    p.add_argument("--results", type=str, default=None, help="output csv")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; never falls back to "
                        "the CPU)")
    args = p.parse_args(argv)

    names = (list(list_models()) if args.model == "all"
             else args.model.split(","))
    rows: List[Dict] = []
    for name in names:
        try:
            row = profile_model(name, args.batch_size, device=args.device)
        except Exception as e:  # noqa: BLE001 — the sweep continues
            print(f"{name}: FAILED ({e})")
            continue
        rows.append(row)
        print(f"{name}: {row['mparams']:.1f}M params, "
              f"image {row['gflops_image']:.2f} GF, "
              f"text {row['gflops_text']:.2f} GF")
    if args.results and rows:
        import csv
        with open(args.results, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


if __name__ == "__main__":
    main()
