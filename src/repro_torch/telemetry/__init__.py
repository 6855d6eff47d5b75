"""telemetry — per-stage run records and the memory-budget model."""
