"""The program's own spans over the profiled attempt: what the sampler
(nshmc_tpu_torch/hmc/engine.py, sampling/ddim.py) records through
nshmc_tpu_torch.utils.profiling.span while a profiler runs, read over the
host-clock window of the attempt traced with the device's activity only,
the same window device_idle_pct reads.

  idle_split  the window's idle time (no kernel, copy or set on the device)
              by what the host was doing, in % of the window: inside
              `hmc.forward` (the loss: DDIM ladder, networks, operator),
              inside `hmc.backward` (autograd's input gradient), and
              anywhere else (the sampler loop: draws, leapfrog arithmetic,
              the MH step and the host syncs). Only the spans of the thread
              that opened `hmc.attempt` count, so the three add up to
              device_idle_pct.
  syncs_per_attempt  `hmc.sync` spans over `hmc.attempt` spans.

Both are None where the program records no spans (a program without
profiling.spans, or a window the record no longer covers) or, for the
idle split, where the trace saw no device activity."""
from __future__ import annotations

from typing import List, Optional, Tuple

LAYERS = {"hmc.forward": "forward", "hmc.backward": "backward"}


def within(trace) -> Optional[list]:
    try:
        from nshmc_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    found = read(trace.t0, trace.t1) if read is not None else None
    return found or None


def idle(trace) -> List[Tuple[int, int]]:
    """The window's intervals with nothing on the device, in order."""
    edges = [trace.t0] + [x for se in trace.busy() for x in se] + [trace.t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_split(trace) -> Optional[dict]:
    found = within(trace)
    if found is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    attempts = [s for s in found if s.name == "hmc.attempt"]
    if not attempts:
        return None
    thread = attempts[0].thread
    gaps = idle(trace)
    window = trace.t1 - trace.t0
    out = {}
    for name, layer in LAYERS.items():
        open_ = sorted((s.start_ns, s.end_ns) for s in found
                       if s.thread == thread and s.name == name)
        out[layer] = 100.0 * overlap(gaps, open_) / window
    out["loop"] = 100.0 * sum(e - s for s, e in gaps) / window - sum(out.values())
    return out


def syncs_per_attempt(trace) -> Optional[float]:
    found = within(trace)
    if found is None:
        return None
    attempts = sum(s.name == "hmc.attempt" for s in found)
    if not attempts:
        return None
    return sum(s.name == "hmc.sync" for s in found) / attempts
