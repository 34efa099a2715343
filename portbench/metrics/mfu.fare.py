"""mfu.fare: the whole step's share of the card's bf16 peak, in percent:
the operations the model's work requires in the traced steps
(`arith.model_flops`: own tokens, causal halves, no recompute) over the
traced window times 989 TFLOP/s.  Moves fare_images_per_s."""
from portbench.metrics import arith


def read(trace):
    work = arith.encodes(trace, "fare")
    if not work or trace.window_s <= 0:
        return None
    flops = sum(arith.model_flops(e) for e in work)
    return 100.0 * flops / (trace.window_s * arith.PEAK_BF16_FLOPS)
