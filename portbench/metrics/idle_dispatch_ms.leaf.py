"""idle_dispatch_ms.leaf: the device's idle ms a traced LEAF step while the
host enqueued encodes: idle time inside the window whose innermost open
program span is a `train.fused.enqueue.*` span or opened inside one, the
spans put on the trace's clock by the benchmark ranges that enclose them
(`spans.py`); None where they do not line up.  Moves
leaf_samples_per_s."""
from portbench.metrics import spans as program


def read(trace):
    return program.idle_ms_under(
        trace, lambda name: name.startswith(program.ENQUEUE))
