"""dispatch_ms.leaf: the host's ms a traced LEAF step spent enqueueing the
encodes: the self time of the program's `train.fused.enqueue.*` spans
(`leaf_tpu_torch.utils.tracing`; phase 1, candidate scoring, the train
update; what spans opened inside them cover, the optimizer's update, left
out) over the traced steps.  Moves leaf_samples_per_s."""
from portbench.metrics import spans as program


def read(trace):
    spans = program.leaf_spans(trace)
    if spans is None:
        return None
    ms = sum(s.ms for s in spans if s.name.startswith(program.ENQUEUE))
    ms -= sum(s.ms for s in spans if s.parent is not None
              and spans[s.parent].name.startswith(program.ENQUEUE))
    return ms / trace.steps
