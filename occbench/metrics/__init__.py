"""Per-layer metrics, one reader a file, found by the metric's name in
BENCHMARK.json: `read(ctx)` takes the traced run's context (its Trace, the
frames or steps traced, the window, the counts of work) and returns the
value, or None where the run has nothing for it to read."""
