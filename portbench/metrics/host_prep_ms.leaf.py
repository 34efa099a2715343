"""host_prep_ms.leaf: the host's seconds preparing the LEAF step's tokens
(slot draws, the probe and candidate edit-and-tokenize grids, the
constraint's masks), in ms a step: the change of the program's counter
`FusedLeafStep.seconds["host"]` over the traced steps.  Moves
leaf_samples_per_s."""


def read(trace):
    if trace.job != "leaf" or "host_s" not in trace.counters \
            or not trace.steps:
        return None
    return 1e3 * trace.counters["host_s"] / trace.steps
