"""Per-layer metrics: one reader a file, ``<metric name>.py``, found by the
name in ``BENCHMARK.json``.  Each defines ``read(ctx)`` (``harness.Context``)
and returns the value, or None where the run has nothing to read."""
