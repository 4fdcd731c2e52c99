"""End-to-end metrics, one file each, found by the metric's name in
BENCHMARK.json: read(w) -> float from window.WindowResult, all on the host's
clock (the window's wall time ends at a synchronise; evaluation times are
in-stream CUDA events read after the window)."""
