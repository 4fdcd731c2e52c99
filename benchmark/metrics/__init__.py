"""Per-layer metrics, one reader a file, found by the metric's name in
BENCHMARK.json. Each module has KERNELS (the device kernel names it reads,
by substring; empty where it reads none) and read(ctx) -> float or None,
where ctx is traced.Context (profiled.py holds the trace). A reader that finds nothing to read returns
None, and the metric is left out of the run's line."""
