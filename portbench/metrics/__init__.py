"""Per-layer metrics: one reader a file, named as the metric, and their
shared arithmetic."""
