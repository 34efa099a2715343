"""Where a serving batch's time goes on one CUDA GPU.

Usage, from the root of a checkout, on a machine with a card:
  python -m leaf_tpu_torch.profile_serve [--out profile.json]

Two parts, each printing its lines and then one JSON object:

  * serve: ViT-L-14-quickgelu, bf16, seed 0, one batch as serve runs it
    (host tokens or pixels to the card, encode, features back to the
    host), for three cells: text at bucket 16 (256 captions, 8 per
    128-token row), text at bucket 77 (256 captions, one per row) and
    images (128 at 224 px).  Per cell: host-clock ms per batch without
    the profiler; then `torch.profiler` over a few batches, with the
    device's kernel intervals merged into busy time and split by kernel
    family.  The idle share is given against both windows, the
    unprofiled one (what serve sees) and the profiled one (which the
    profiler's own host overhead stretches).
  * gemm: the fused block's GEMM + bias kernel (`leaf_gemm_bias`: bf16 on
    `wgmma` fed by TMA, fp32 as 3xTF32 on `wgmma`) against `torch.addmm` (cuBLAS,
    TF32 off) at the block's qkv and out-projection shapes of the serving
    batches and of a training step's scoring encode, timed with CUDA
    events in turns (cuBLAS, kernel, kernel, cuBLAS).

Token ids are synthetic (SOT, random ids, EOT): the tokenizer runs on
the host before serve's timer and is not profiled here.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

MODEL = "ViT-L-14-quickgelu"
SOT, EOT = 49406, 49407
# unprofiled batches timed per cell (fewer of the much longer image batches)
TEXT_BATCHES, IMAGE_BATCHES = 20, 5
# kernel families, by a substring of the kernel's name; the first match wins;
# what none names is "other", split by where it was launched: in autograd's
# backward (the engine's evaluate_function ranges, remat's recompute among
# them) or before it (the forward's glue, the update)
FAMILIES = (("backward kernels", ("attention_backward", "layer_norm_backward")),
            ("attention kernel", ("attention_kernel",)),
            ("hand GEMMs", ("gemm_bias_",)),
            ("LayerNorm kernel", ("layer_norm_rows_kernel", "layer_norm_regs_kernel",
                                  "layer_norm_global_kernel")),
            ("cuBLAS", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
            ("copies", ("Memcpy", "Memset")))
# (name, M tokens per batch, K, N) of the fused block's two GEMMs: a serving
# batch at buckets 16 and 77 and of images, and one scoring encode of the
# trainer (6,400 candidates at bucket 16)
GEMM_SHAPES = [("s16 qkv", 32 * 128, 768, 2304), ("s16 out", 32 * 128, 768, 768),
               ("s77 qkv", 256 * 77, 768, 2304), ("s77 out", 256 * 77, 768, 768),
               ("vision qkv", 128 * 257, 1024, 3072),
               ("vision out", 128 * 257, 1024, 1024),
               ("train qkv", 800 * 128, 768, 2304),
               ("train out", 800 * 128, 768, 768)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _tokens(rng, batch: int, seq_len: int, lo: int, hi: int) -> np.ndarray:
    toks = np.zeros((batch, seq_len), np.int32)
    for row in toks:
        n = int(rng.integers(lo, hi + 1))
        row[0] = SOT
        row[1:n + 1] = rng.integers(1, SOT, n)
        row[n + 1] = EOT
    return toks


def _family(name: str, backward: bool = False) -> str:
    for family, keys in FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other: backward" if backward else "other: forward glue"


def _backward_other_us(events) -> float:
    """Device time (us) of the "other" kernels launched inside autograd's
    backward: the kernels that the profiler ties to a host call (a
    `cudaLaunchKernel`, its `kernels`) that starts within an
    `autograd::engine::evaluate_function` range of its thread."""
    import bisect
    from torch.autograd import DeviceType
    spans = {}
    for e in events:
        if (e.device_type == DeviceType.CPU
                and e.name.startswith("autograd::engine::evaluate_function")):
            spans.setdefault(e.thread, []).append((e.time_range.start,
                                                   e.time_range.end))
    merged = {}
    for thread, ranges in spans.items():
        out = []
        for lo, hi in sorted(ranges):
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        merged[thread] = ([lo for lo, _ in out], [hi for _, hi in out])
    us = 0.0
    for e in events:
        if (e.device_type != DeviceType.CPU or not e.kernels
                or e.thread not in merged):
            continue
        starts, ends = merged[e.thread]
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < ends[i]:
            us += sum(k.duration for k in e.kernels
                      if _family(k.name, True) == "other: backward")
    return us


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_cell(name: str, batch_fn, batches: int, warm: int = 3,
                 profiled: int = 5) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    for _ in range(warm):
        batch_fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batches):
        batch_fn()
    plain_ms = (time.perf_counter() - t0) * 1e3 / batches

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            batch_fn()
        window_ms = (time.perf_counter() - t0) * 1e3 / profiled
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        raise RuntimeError(f"{name}: the profiler recorded no device events")
    busy_ms = _busy_us((e.time_range.start, e.time_range.end)
                       for e in device) / 1e3 / profiled
    by_family = {}
    for e in device:
        fam = _family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3 / profiled
    backward_other = min(_backward_other_us(events) / 1e3 / profiled,
                         by_family.get("other: forward glue", 0.0))
    if backward_other:
        by_family["other: backward"] = backward_other
        by_family["other: forward glue"] -= backward_other
    row = {"cell": name, "ms_per_batch": plain_ms,
           "profiled_ms_per_batch": window_ms, "busy_ms_per_batch": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / plain_ms),
           "idle_share_profiled": max(0.0, 1 - busy_ms / window_ms),
           "device_ms_by_family": by_family,
           "device_events_per_batch": len(device) / profiled}
    fams = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_family.items()))
    print(f"{name}: {plain_ms:.3f} ms/batch unprofiled, {window_ms:.3f} "
          f"profiled; device busy {busy_ms:.3f} ms/batch, idle share "
          f"{row['idle_share']:.3f} of the unprofiled window, "
          f"{row['idle_share_profiled']:.3f} of the profiled one; "
          f"device ms/batch by family: {fams}", flush=True)
    return row


def profile_serve() -> list:
    from leaf_tpu_torch.models.factory import create_model
    model = create_model(MODEL, precision="bf16", seed=0, device="cuda")
    rng = np.random.default_rng(0)
    s16 = _tokens(rng, 256, 16, 3, 12)
    s77 = _tokens(rng, 256, 77, 60, 75)
    images = rng.standard_normal((128, 224, 224, 3)).astype(np.float32)

    def host(t):
        return t.float().cpu().numpy()

    with torch.inference_mode():
        return [
            profile_cell("text bucket 16", lambda: host(
                model.encode_text(s16, True)), TEXT_BATCHES),
            profile_cell("text bucket 77", lambda: host(
                model.encode_text(s77, True)), TEXT_BATCHES),
            profile_cell("images", lambda: host(
                model.encode_image(images, True)), IMAGE_BATCHES),
        ]


def _time_ms(fn, n: int = 20) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profile_gemm() -> list:
    from leaf_tpu_torch.ops import build
    from leaf_tpu_torch.ops.packed_attention import _DTYPE_CODES
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, M, K, N in GEMM_SHAPES:
            a = torch.randn(M, K, device="cuda", generator=g).to(dtype)
            w = (torch.randn(K, N, device="cuda", generator=g)
                 * K ** -0.5).to(dtype)
            b = torch.randn(N, device="cuda", generator=g).to(dtype)
            out = torch.empty(M, N, device="cuda", dtype=dtype)

            def kernel():
                # the C entry itself, into one output: at the small shapes
                # a wrapper's checks and allocation would outlast the kernel
                build.check(lib.leaf_gemm_bias(
                    a.data_ptr(), w.data_ptr(), b.data_ptr(), None,
                    out.data_ptr(), _DTYPE_CODES[dtype], M, N, K,
                    a.device.index, stream), "gemm_bias")

            def cublas():
                return torch.addmm(b, a, w)

            kernel()
            err = (out.float() - cublas().float()).abs().max().item()
            c1, k1, k2, c2 = (_time_ms(f) for f in (cublas, kernel, kernel,
                                                    cublas))
            k, c = (k1 + k2) / 2, (c1 + c2) / 2
            flop = 2 * M * N * K
            row = {"shape": name, "dtype": str(dtype).split(".")[-1], "M": M,
                   "K": K, "N": N, "kernel_ms": k, "cublas_ms": c,
                   "kernel_tflops": flop / k / 1e9,
                   "cublas_tflops": flop / c / 1e9, "max_abs_err": err}
            rows.append(row)
            print(f"gemm {row['dtype']} {name} ({M}x{K}x{N}): kernel {k:.4f} "
                  f"ms ({row['kernel_tflops']:.1f} TFLOP/s), cuBLAS {c:.4f} "
                  f"ms ({row['cublas_tflops']:.1f} TFLOP/s), max abs err "
                  f"{err:.3g}", flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("leaf_tpu_torch.profile_serve")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    result = {"card": card(), "device": torch.cuda.get_device_name(0)}
    print(result["card"], flush=True)
    result["serve"] = profile_serve()
    result["gemm"] = profile_gemm()
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
