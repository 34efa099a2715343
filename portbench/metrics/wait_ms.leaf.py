"""wait_ms.leaf: the host's ms a traced LEAF step blocked on the best-probe
readbacks: the durations of the program's `train.fused.wait` spans
(`leaf_tpu_torch.utils.tracing`) over the traced steps.  Moves
leaf_samples_per_s."""
from portbench.metrics import spans as program


def read(trace):
    spans = program.leaf_spans(trace)
    if spans is None:
        return None
    return sum(s.ms for s in spans
               if s.name == "train.fused.wait") / trace.steps
