"""Per-layer metric readers, one file each, named as the metric:
``read(ctx)`` takes the number from the run's counters, the port's
result dicts, the device trace or a probe, and returns None where the
run has nothing to read."""
