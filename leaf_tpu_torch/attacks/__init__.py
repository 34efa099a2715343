"""Attack-side helpers of the port.  Only the context bucketing that the
serving path shares with candidate scoring is ported so far."""
