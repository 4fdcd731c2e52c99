"""What a `--trace 1` run hands the per-layer readers (metrics/*.py)."""
from __future__ import annotations

import dataclasses

from sites import Sites
from profiled import Trace


@dataclasses.dataclass
class Context:
    trace: Trace
    evals: int                 # evaluations in the profiled attempt
    sites: Sites               # one evaluation's GroupNorm calls
    sites_agree: bool          # the program's counters moved by evals x the sites' launches
    flops_per_eval: float
    evals_per_s: float         # of the run's untraced window
    chains: int                # in one batch
    peak_flops_per_s: float    # None where peaks.json has no entry for the device
    hbm_bytes_per_s: float
