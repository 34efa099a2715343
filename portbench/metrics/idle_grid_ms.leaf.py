"""idle_grid_ms.leaf: the device's idle ms a traced LEAF step while the
host built token grids: idle time inside the window whose innermost open
program span is `train.fused.prepare`, `.candidates` or `.clean` or opened
inside one, the spans put on the trace's clock by the benchmark ranges
that enclose them (`spans.py`); None where they do not line up.  Moves
leaf_samples_per_s."""
from portbench.metrics import spans as program


def read(trace):
    return program.idle_ms_under(trace, lambda name: name in program.GRID)
