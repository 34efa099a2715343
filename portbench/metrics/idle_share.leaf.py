"""idle_share.leaf: the share of the traced window, in percent, in which no
operation ran on the device: 1 - (union of the device's operation
intervals) / (the window).  Moves leaf_samples_per_s."""


def read(trace):
    if trace.job != "leaf" or trace.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)
