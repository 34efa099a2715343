"""Data layer of the port.  Only the synthetic dataset is ported so far."""
