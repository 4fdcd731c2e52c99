"""The measured window: a closed loop with one client, MH attempts back to
back on one image's chains through the program's own driver, until the
first attempt boundary after --seconds (and after the attempt sampled for
the check). If every chain finishes its budget inside the window, fresh
chains start on the next image made from the seed.

`Recorder` wraps the loss callable that the benchmark hands the driver. At
each evaluation it records a CUDA event in the stream (no synchronisation;
the events are read after the window). In the attempt sampled for the check
it also copies, without blocking, each evaluation's position, energy and
gradient (and the first evaluation's decoded output and image) to pinned
host memory, and the callback keeps the chains' state before and after that
attempt and the MH decisions of the image's attempts before it."""
from __future__ import annotations

import dataclasses
import time
from typing import List

import torch


class WindowClosed(Exception):
    pass


class Clock:
    """In-stream CUDA events on a card; the host clock on the CPU (tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def snapshot(state) -> dict:
    """Every field of a chain state, on the host."""
    return {f.name: getattr(state, f.name).detach().cpu()
            for f in dataclasses.fields(state) if f.name != "samples"}


@dataclasses.dataclass
class Sample:
    """What the check reads of the sampled attempt."""
    attempt: int
    y0: torch.Tensor = None
    state_in: dict = None
    state_out: dict = None
    p0: torch.Tensor = None
    u: torch.Tensor = None
    x: torch.Tensor = None       # (L + 1, N, ...) positions
    grad: torch.Tensor = None    # (L + 1, N, ...)
    loss: torch.Tensor = None    # (L + 1, N)
    dec0: torch.Tensor = None    # (N, ...) the first evaluation's decoded output (x's shape)
    img0: torch.Tensor = None    # (N, H, W, C) its image, where the program taps one apart
    decisions: torch.Tensor = None  # (A, N) bool: the image's earlier attempts' accepts


class Recorder:
    def __init__(self, device, n_leapfrog: int, sample_attempt: int, n_chains: int, x_shape):
        self.clock = Clock(device)
        self.evals_per_attempt = n_leapfrog + 1
        self.marks: List = []
        self.losses: List[torch.Tensor] = []
        self.n_evals = 0
        self.attempts = 0
        self.images = 0
        pin = self.clock.cuda
        buf = lambda *shape: torch.empty(shape, pin_memory=pin)
        k = self.evals_per_attempt
        self.sample = Sample(sample_attempt, x=buf(k, n_chains, *x_shape),
                             grad=buf(k, n_chains, *x_shape), loss=buf(k, n_chains),
                             dec0=buf(n_chains, *x_shape), p0=buf(n_chains, *x_shape),
                             u=buf(n_chains))
        self.deadline = None
        self.last = None          # the chains' state after the latest attempt
        self.counts = []          # the image's accept counters, up to the sampled attempt
        self._keep_image = False  # the next tapped image is the sampled attempt's first
        self.y0 = None            # the current image's y0
        self.draws_last = None    # the current image's draws

    def sampling(self) -> bool:
        return self.attempts == self.sample.attempt

    def start_image(self, state, y0):
        """Fresh chains on image `self.images`; called before their first
        attempt."""
        self.last, self.y0 = state, y0
        self.counts = [state.accepted]
        if self.sampling():
            self._sampled(state)
        self.images += 1

    def _sampled(self, state):
        """The sampled attempt starts from `state`."""
        self.sample.state_in = snapshot(state)
        self.sample.y0 = self.y0.detach().cpu()
        counts = torch.stack([c.detach().cpu() for c in self.counts])
        self.sample.decisions = counts.diff(dim=0) > 0
        self.counts = []

    def on_draw(self, p0, u):
        if self.sampling():
            self.sample.p0.copy_(p0, non_blocking=True)
            self.sample.u.copy_(u, non_blocking=True)

    def wrap(self, loss_fn):
        s = self.sample

        def fn(x):
            self.marks.append(self.clock.mark())
            attempt, k = divmod(self.n_evals, self.evals_per_attempt)
            self.n_evals += 1
            keep = attempt == s.attempt
            self._keep_image = keep and k == 0
            if keep:
                s.x[k].copy_(x.detach(), non_blocking=True)
                if x.requires_grad:
                    x.register_hook(self._grad_copier(k))
            loss, dec = loss_fn(x)
            self._keep_image = False
            self.losses.append(loss.detach())
            if keep:
                s.loss[k].copy_(loss.detach(), non_blocking=True)
                if k == 0:
                    s.dec0.copy_(dec.detach(), non_blocking=True)
            return loss, dec
        return fn

    def tap(self, img: torch.Tensor):
        """The program's image of an evaluation (systems' loss_fn calls it)."""
        if self._keep_image:
            if self.sample.img0 is None:
                self.sample.img0 = torch.empty(img.shape, dtype=img.dtype,
                                               pin_memory=self.clock.cuda)
            self.sample.img0.copy_(img.detach(), non_blocking=True)

    def _grad_copier(self, k: int):
        def hook(g):
            self.sample.grad[k].copy_(g, non_blocking=True)
        return hook

    def callback(self, state, rnd):
        self.attempts += 1
        self.last = state
        if self.attempts <= self.sample.attempt:
            self.counts.append(state.accepted)
        if self.attempts == self.sample.attempt + 1:
            self.sample.state_out = snapshot(state)
        if self.sampling():
            self._sampled(state)
        if (self.deadline is not None and time.perf_counter() >= self.deadline
                and self.attempts > self.sample.attempt):
            raise WindowClosed()

    def eval_ms(self, end_mark) -> List[float]:
        marks = self.marks + [end_mark]
        return [self.clock.ms(a, b) for a, b in zip(marks[:-1], marks[1:])]

    def nonfinite(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.cat(self.losses))).sum())


@dataclasses.dataclass
class WindowResult:
    wall_s: float
    n_evals: int
    attempts: int
    chains: int
    eval_ms: List[float]
    peak_bytes: int
    nonfinite: int
    setup_s: float = 0.0


def run_window(program, rec: Recorder, seconds: float, chains: int, image_inputs,
               draws_for, device) -> WindowResult:
    """Drive the program's chains for `seconds` (see the module's doc).
    image_inputs(i) -> (y0, x_T) of image i; draws_for(i) -> its draws."""
    clock = rec.clock
    cuda = clock.cuda
    clock.sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec.deadline = t0 + seconds
    while True:
        y0, x_t = image_inputs(rec.images)
        state = program.init_state(x_t)
        loss_fn = rec.wrap(program.loss_fn(y0, rec.tap))
        draws = draws_for(rec.images)
        draws.on_draw = rec.on_draw
        rec.draws_last = draws
        rec.start_image(state, y0)
        try:
            program.run(loss_fn, state, draws, rec.callback)
        except WindowClosed:
            break
    end = clock.mark()
    clock.sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return WindowResult(wall_s=wall, n_evals=rec.n_evals, attempts=rec.attempts, chains=chains,
                        eval_ms=rec.eval_ms(end), peak_bytes=peak, nonfinite=rec.nonfinite())
