"""One reader per per-layer metric: ``read(ctx)`` takes a
:class:`bench.harness.Context` and returns the metric's value, or None
where the run gave it nothing to read."""
