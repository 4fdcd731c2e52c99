"""The traced part of a `--trace 1` run: one whole attempt (its L + 1
evaluations and its MH step) under torch.profiler, reduced in memory to
device intervals and host operations (no trace file is written).

  busy_s    the union of the device's kernel, copy and set intervals inside
            the attempt's host-clock window (synchronised at both ends)
  window_s  that window
  breakdown the device operations that took most time, and the longest
            gaps with nothing on the device, each named by the innermost
            host operation running at its middle (read from a second
            attempt, traced with the host's operations)"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
from typing import List, Tuple

import torch


@dataclasses.dataclass
class Trace:
    t0: int                                   # ns, host clock (time.time_ns)
    t1: int
    device: List[Tuple[str, int, int]]        # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]          # (name, start ns, end ns)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy(self) -> List[Tuple[int, int]]:
        """Merged device intervals clipped to the window."""
        spans = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.device
                       if e > self.t0 and s < self.t1)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name contains any of `names`."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names)) * 1e-9

    def device_ops(self, top: int = 10):
        tot = collections.Counter()
        for n, s, e in self.device:
            tot[short(n)] += e - s
        return [[n, ns * 1e-9] for n, ns in tot.most_common(top)]

    def idle_gaps(self, top: int = 10):
        merged = self.busy()
        edges = [self.t0] + [x for se in merged for x in se] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for length, start in gaps[:top]:
            mid = start + length // 2
            i = bisect.bisect_right(starts, mid)
            name = "no host op recorded"
            for j in range(i - 1, max(-1, i - 2000), -1):  # the latest-starting op still running
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            out.append([short(name), length * 1e-9])
        return out


def short(name: str, n: int = 96) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= n else name[:n - 3] + "..."


def profile(fn, host: bool = True) -> Trace:
    """Run fn() (one attempt) under the profiler: the device's activity, and
    with `host` the host's operations too (which slows a host-bound run, so
    the busy share is read from an attempt traced without them). Without a
    card, the host's alone, and nothing counts as device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.time_ns()
        fn()
        sync()
        t1 = time.time_ns()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return Trace(t0, t1, device, host)
