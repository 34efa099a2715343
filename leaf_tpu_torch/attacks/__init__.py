"""Attack side of the port: sentence edits, the candidate scoring engine
and the LEAF training attack."""
