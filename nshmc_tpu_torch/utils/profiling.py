"""Tracing and profiling helpers on torch.profiler (port of
nshmc_tpu/utils/profiling.py).

  - `trace(dirname)`: profile the block (CPU, and CUDA where there is a
    card) and write a Chrome trace, dirname/trace.json.
  - `named(name)`: a region that shows in the profiler's timeline
    (`record_function`), and in Nsight as an NVTX range where CUDA is up.
  - `Timer`: wall-clock records by name, synchronising a CUDA device first
    when asked.
  - `compiled_flops(fn, *args)`: the FLOPs of one call, counted op by op
    with torch.utils.flop_counter's formulas (2 per multiply-add of the
    matmuls and convolutions it runs, forward and any backward it runs).
  - `enable_persistent_cache`: XLA's compilation cache has no counterpart
    here (nothing is compiled ahead of a run), so it does nothing and
    returns None.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


def enable_persistent_cache(path: Optional[str] = None) -> None:
    """A no-op kept for the JAX package's callers: there is no XLA cache to
    enable. Returns None, as the JAX helper does when it cannot enable it."""
    return None


@contextlib.contextmanager
def trace(dirname: str):
    """Profile the block and write dirname/trace.json (Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with profile(activities=activities) as prof:
        yield dirname
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


@contextlib.contextmanager
def named(name: str):
    """Annotate a region (leapfrog / energy / metrics) for the profiler and,
    on CUDA, for NVTX."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()



class Timer:
    """Wall-clock timing; `sync` (a tensor or a device) is synchronised
    before the clock stops when it is on CUDA."""

    def __init__(self):
        self.records = {}

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        t0 = time.time()
        yield
        if sync is not None:
            device = torch.device(sync.device if isinstance(sync, torch.Tensor) else sync)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.records.setdefault(name, []).append(time.time() - t0)

    def summary(self) -> dict:
        import numpy as np

        return {k: {"mean_s": float(np.mean(v)), "n": len(v), "total_s": float(np.sum(v))}
                for k, v in self.records.items()}

    def dump(self, path: Optional[str] = None):
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


def compiled_flops(fn, *args) -> float:
    """FLOPs of fn(*args), counted while it runs: each aten op that
    torch.utils.flop_counter has a formula for (matmuls, convolutions and
    their backward, attention) adds its count, the useful-FLOP numerator of
    a utilisation figure. FlopCounterMode itself is not used: its module
    tracker hooks every module's inputs, and torch.autograd.grad with
    respect to a leaf input (the HMC gradient) then raises."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.total += formula(*args, **kwargs, out_val=out)
            return out

    with Count() as count:
        fn(*args)
    return float(count.total)
