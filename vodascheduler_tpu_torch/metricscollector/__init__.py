"""The per-epoch telemetry CSV the metrics collector reads."""
