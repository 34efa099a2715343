"""Evaluations of the port (no eager imports)."""
