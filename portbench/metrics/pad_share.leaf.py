"""pad_share.leaf: the share, in percent, of the token slots the traced
LEAF steps' encodes computed that were bucket padding: 100 x (1 - own
tokens / slots), summed over the program's `train.fused.enqueue.*` spans'
counts (`own_tokens` SOT to EOT, `slots` rows x bucket width).  Moves
leaf_samples_per_s."""
from portbench.metrics import spans as program


def read(trace):
    spans = program.leaf_spans(trace)
    if spans is None:
        return None
    enq = [s.counts for s in spans if s.name.startswith(program.ENQUEUE)]
    slots = sum(c.get("slots", 0) for c in enq)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(c.get("own_tokens", 0) for c in enq) / slots)
