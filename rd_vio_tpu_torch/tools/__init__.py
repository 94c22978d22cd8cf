"""Measurement helpers and scripts of the port (not used by the pipeline)."""
