"""Spans of the sampler and FLOP counting on torch.profiler (port of
nshmc_tpu/utils/profiling.py).

  - `span(name)`: a region of the sampler (an MH attempt, a leapfrog step,
    a forward, a backward, a host synchronisation, ...), recorded in memory
    while a torch profiler is active and not at all otherwise. It adds no
    event to the profiler's trace (no `record_function`, no NVTX range), so
    the device intervals and host operations a trace holds are the same
    with or without spans; the spans share the trace's clock
    (`time.time_ns`), so a reader lays them over the trace's device
    intervals.
  - `spans(t0_ns, t1_ns)`: the spans that lie within a window, or None
    where the bounded record has already dropped part of it.
  - `compiled_flops(fn, *args)`: the FLOPs of one call, counted op by op
    with torch.utils.flop_counter's formulas (2 per multiply-add of the
    matmuls and convolutions it runs, forward and any backward it runs).

For Nsight ranges, run under `torch.autograd.profiler.emit_nvtx()`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

SPAN_LIMIT = 65_536  # spans kept; a traced MH attempt of the flagship records ~215


class Span(NamedTuple):
    name: str
    start_ns: int         # time.time_ns(), the clock of the profiler's events
    end_ns: int
    id: int
    parent: Optional[int]  # id of the span open around it on its thread
    thread: int           # threading.get_ident() of the thread it ran on
    attempt: Optional[int]  # id of the attempt span open when it began


class _Stacks(threading.local):
    def __init__(self):
        self.stack = []  # ids of the spans open on this thread, innermost last


class SpanRecord:
    """A bounded in-memory record of spans, oldest dropped first. Each
    thread keeps its own stack of open spans; the open attempt is shared by
    every thread (autograd's device threads run inside the caller's
    attempt)."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self._done = collections.deque(maxlen=limit)
        self._lost_ns = None  # end of the newest span dropped
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = _Stacks()
        self._attempt = None

    def span(self, name: str, attempt: bool = False):
        """Context manager: the block as span `name` while a profiler is
        active. `attempt`: the span is an MH attempt, whose id every span
        begun inside it carries."""
        if not torch._C._autograd._profiler_enabled():
            return _OFF
        return self._open(name, attempt)

    def within(self, t0_ns: int, t1_ns: int) -> Optional[List[Span]]:
        """The spans that began at or after t0_ns and ended by t1_ns, by
        start; None where a dropped span ended at or after t0_ns."""
        with self._lock:
            if self._lost_ns is not None and self._lost_ns >= t0_ns:
                return None
            done = list(self._done)
        return sorted((s for s in done if s.start_ns >= t0_ns and s.end_ns <= t1_ns),
                      key=lambda s: s.start_ns)

    @contextlib.contextmanager
    def _open(self, name: str, attempt: bool):
        stack = self._local.stack
        sid, parent, outer = next(self._ids), (stack[-1] if stack else None), self._attempt
        if attempt:
            self._attempt = sid
        in_attempt = self._attempt
        stack.append(sid)
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            stack.pop()
            if attempt:
                self._attempt = outer
            with self._lock:
                if len(self._done) == self._done.maxlen:
                    self._lost_ns = self._done[0].end_ns
                self._done.append(Span(name, start, end, sid, parent, threading.get_ident(),
                                       in_attempt))


_OFF = contextlib.nullcontext()
_RECORD = SpanRecord()
span = _RECORD.span
spans = _RECORD.within


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
