"""Host-side utilities of the port: meters, CSV ledgers, logging."""
