"""The yardstick's arithmetic, shared by the per-layer metrics' readers:
the data-sheet peaks, the operations and bytes that the model's work
requires (counted from the shapes, whatever kernel implements it), the
union of device intervals and the sums by kernel name.

Counting rules:
- A sequence counts its own tokens, SOT to EOT (no bucket padding); an
  image its patches and class token.
- Causal attention counts the half of the score matrix it needs.
- A forward's matrix products 2 * tokens * (4 D^2 + 2 D * mlp) a layer; a
  backward for the input's gradient alone as much again; one for the
  weights' too twice as much.  Attention's backward is twice its forward.
  Recompute (remat, the block backward's) is not counted.
- Bytes: each input byte read once and each output byte written once, in
  the compute dtype (bf16: 2 bytes).
- Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s
  bf16, 3.35 TB/s HBM3, at the card's full 700 W (the result's `device`
  gives the card's power limit, `power_limit_w`, beside them).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2


@dataclasses.dataclass
class Encode:
    """One pass of a tower over a set of sequences, as the model requires
    it: `grad` is "none" (a forward), "input" (a forward and the input's
    gradient) or "all" (also the weights')."""
    width: int
    layers: int
    heads: int
    mlp: int
    embed: int
    lengths: np.ndarray            # tokens of each sequence
    causal: bool
    grad: str = "none"
    patch_dim: int = 0             # vision: 3 p^2 (0 for text)

    @property
    def tokens(self) -> int:
        return int(self.lengths.sum())

    def attention_pairs(self) -> float:
        """Score-matrix entries the model needs, summed over sequences."""
        sq = float((self.lengths.astype(np.float64) ** 2).sum())
        return sq / 2 if self.causal else sq


def layer_gemm_flops(e: Encode) -> float:
    """One layer's forward matrix products (qkv, out, the MLP's two)."""
    D = e.width
    return 2.0 * e.tokens * (4 * D * D + 2 * D * e.mlp)


def layer_attention_flops(e: Encode) -> float:
    """One layer's forward attention: Q K^T and P V."""
    return 4.0 * e.attention_pairs() * e.width


def model_flops(e: Encode) -> float:
    """The whole encode's operations, its backward included."""
    passes = {"none": 1, "input": 2, "all": 3}[e.grad]
    attn = 1 if e.grad == "none" else 3
    layers = e.layers * (passes * layer_gemm_flops(e)
                         + attn * layer_attention_flops(e))
    n_seq = len(e.lengths)
    tail = 2.0 * n_seq * e.width * e.embed * passes
    patches = 2.0 * (e.tokens - n_seq) * e.patch_dim * e.width
    patches *= {"none": 1, "input": 2, "all": 2}[e.grad]
    return layers + tail + patches


def bound_s(flops: float, n_bytes: float,
            peak: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the memory's rate, whichever is longer."""
    return max(flops / peak, n_bytes / PEAK_BYTES_PER_S)


def attention_forward_bound_s(e: Encode) -> float:
    """Sum over the encode's attention calls (one a layer): qkv read, the
    output written."""
    n_bytes = 4 * e.tokens * e.width * BF16
    return e.layers * bound_s(layer_attention_flops(e), n_bytes)


def attention_backward_bound_s(e: Encode) -> float:
    """Sum over the encode's attention-backward calls: qkv, out, dout and
    the fp32 log-sum-exp read, dqkv written; twice the forward's
    operations."""
    n_bytes = 8 * e.tokens * e.width * BF16 + 4 * e.tokens * e.heads
    return e.layers * bound_s(2 * layer_attention_flops(e), n_bytes)


def gemm_forward_bound_s(e: Encode) -> float:
    """Sum over the block's two forward products a layer: qkv
    (M x D x 3D) and out (M x D x D, the residual read): operand, weight
    and bias read, result written."""
    D, M = e.width, e.tokens
    qkv = bound_s(2.0 * M * D * 3 * D,
                  (M * D + 3 * D * D + 3 * D + 3 * M * D) * BF16)
    out = bound_s(2.0 * M * D * D,
                  (M * D + D * D + D + 2 * M * D) * BF16)
    return e.layers * (qkv + out)


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (in their unit)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def kernel_seconds(kernels, include: Sequence[str],
                   exclude: Sequence[str] = ()) -> float:
    """Device seconds of the kernels whose name holds one of `include`
    and none of `exclude` (kernels as (name, start_s, end_s))."""
    return sum(end - start for name, start, end in kernels
               if any(k in name for k in include)
               and not any(k in name for k in exclude))


def busy_s(kernels) -> float:
    return union_s((start, end) for _, start, end in kernels)


def share_percent(bound: float, seconds: float):
    """A roofline share in percent, or None where no kernel ran."""
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds


def encodes(trace, job: str) -> List[Encode]:
    """The profiled steps' encodes, where the trace is of `job`."""
    return list(trace.work) if trace.job == job else []
