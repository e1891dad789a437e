"""Tracing for the port's supervisor: spans that stitch into the
scheduler's traces."""
