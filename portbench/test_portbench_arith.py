"""The per-layer metrics' arithmetic on shapes worked out by hand, and the
trace's reduction on a made-up trace."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import Spec
from portbench.metrics import arith
from portbench.trace import WINDOW, Trace


def _encode(grad="none", causal=True):
    # two sequences of 3 and 5 tokens, width 4, 2 layers, mlp 16, embed 3
    return arith.Encode(width=4, layers=2, heads=2, mlp=16, embed=3,
                        lengths=np.array([3, 5]), causal=causal, grad=grad)


def test_operations_by_hand():
    e = _encode()
    assert e.tokens == 8
    assert e.attention_pairs() == (9 + 25) / 2
    assert _encode(causal=False).attention_pairs() == 34
    # 2 * 8 tokens * (4 * 16 + 2 * 4 * 16)
    assert arith.layer_gemm_flops(e) == 3072
    # 4 * 17 pairs * width 4
    assert arith.layer_attention_flops(e) == 272
    # 2 layers * (3072 + 272) + the projection 2 * 2 * 4 * 3
    assert arith.model_flops(e) == 6736
    # the input's gradient: products twice, attention three times
    assert arith.model_flops(_encode("input")) == 2 * (2 * 3072 + 3 * 272) + 96
    assert arith.model_flops(_encode("all")) == 2 * (3 * 3072 + 3 * 272) + 144


def test_bounds_by_hand():
    e = _encode()
    peak, bw = arith.PEAK_BF16_FLOPS, arith.PEAK_BYTES_PER_S
    assert arith.bound_s(1e12, 1.0) == pytest.approx(1e12 / peak)
    assert arith.bound_s(1.0, 1e12) == pytest.approx(1e12 / bw)
    # qkv and out read once, in bf16: 4 * 8 * 4 * 2 bytes
    assert arith.attention_forward_bound_s(e) == pytest.approx(
        2 * max(272 / peak, 256 / bw))
    # qkv: 2*8*4*12 ops, (32 + 48 + 12 + 96) * 2 bytes; out: 2*8*4*4 ops,
    # (32 + 16 + 4 + 64) * 2 bytes
    assert arith.gemm_forward_bound_s(e) == pytest.approx(
        2 * (max(768 / peak, 376 / bw) + max(256 / peak, 232 / bw)))
    # qkv, out, dout in bf16 and the fp32 lse read, dqkv written
    assert arith.attention_backward_bound_s(e) == pytest.approx(
        2 * max(544 / peak, (8 * 8 * 4 * 2 + 4 * 8 * 2) / bw))


def test_intervals_and_kernel_sums():
    assert arith.union_s([(0, 2), (1, 3), (5, 6)]) == 3 + 1
    kernels = [("gemm_bias_wgmma_kernel<192>", 0.0, 1.0),
               ("attention_kernel<64>", 1.0, 1.5),
               ("attention_backward_dq_kernel", 2.0, 4.0)]
    assert arith.kernel_seconds(kernels, ("attention_kernel",)) == 0.5
    assert arith.kernel_seconds(kernels, ("attention_",),
                                ("backward",)) == 0.5
    assert arith.busy_s(kernels) == 3.5
    assert arith.share_percent(1.0, 0.0) is None
    assert arith.share_percent(1.0, 4.0) == 25.0


def _trace(job="leaf"):
    kernels = [("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("k3", 6.0, 7.0)]
    ranges = [(WINDOW, 0.0, 10.0), ("leaf.step", 0.0, 5.0),
              ("leaf.prepare_probes", 5.0, 10.0)]
    return Trace(job=job, steps=3, window_s=10.0, busy_s=arith.busy_s(kernels),
                 kernels=kernels, ranges=ranges, work=[_encode("all")],
                 counters={"host_s": 0.3})


def test_idle_gaps_take_the_host_range_open_at_their_middle():
    t = _trace()
    assert t.idle_by_range() == [("leaf.prepare_probes", 5.0),
                                 ("leaf.step", 1.0)]
    out = t.breakdown()
    assert out["device_ops"][0] == ["k1", 2.0]
    assert out["idle_gaps"][0] == ["leaf.prepare_probes", 5.0]


def test_readers_on_a_made_up_trace(tiny_root):
    spec = Spec(tiny_root)
    t = _trace()
    assert spec.reader("idle_share.leaf")(t) == pytest.approx(60.0)
    assert spec.reader("host_prep_ms.leaf")(t) == pytest.approx(100.0)
    assert spec.reader("mfu.leaf")(t) == pytest.approx(
        100 * arith.model_flops(_encode("all")) / (10 * arith.PEAK_BF16_FLOPS))
    # the kernels named nothing a roofline reads
    assert spec.reader("attn_roofline.leaf")(t) is None
    # a reader returns nothing for another job's trace
    for name in ("idle_share.fare", "mfu.fare", "gemm_roofline.fare"):
        assert spec.reader(name)(t) is None
    # a metric added as a file and an entry
    assert "steps_traced.fixture" in {
        m["name"] for m in spec.per_layer("tiny.leaf")}
    assert spec.reader("steps_traced.fixture")(t) == 3.0
