"""The readers of the program's spans (spans.py; metrics idle_fwd_pct,
idle_bwd_pct, idle_loop_pct, host_syncs_per_attempt): exact values on a
hand-made trace, the three idle shares adding up to device_idle_pct, no
reading from a program that records no spans, and the tiny cells' syncs
traced on the CPU. On the card (`-m card`), one attempt of each hmc8 cell
under torch.cuda's sync debug mode: every synchronisation it warns of lies
in an `hmc.sync` span, and the readers' idle shares add up on a real
trace.

    python3 -m pytest benchmark/tests/test_bench_spans.py -q -m card -s   # on the chip"""
import collections
import threading
import time
import traceback
import types
import warnings

import pytest
import torch

import cells
import profiled
import run
import spans
import systems
import tiny
import window
from metrics import device_idle_pct, host_syncs_per_attempt, idle_bwd_pct, idle_fwd_pct
from metrics import idle_loop_pct
from nshmc_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SEED = 2 ** 33 + 11
IDLE = (idle_fwd_pct, idle_bwd_pct, idle_loop_pct)
SPAN_NAMES = {"hmc.attempt", "hmc.sync", "hmc.leapfrog_step", "hmc.forward", "hmc.backward",
              "ddim.step", "ddim.model", "operator", "vq.decode"}


def _span(name, start, end, thread=1, parent=None, id_=0):
    return profiling.Span(name, start, end, id_, parent, thread, 1)


def _context(device, found, monkeypatch, t0=0, t1=1000):
    monkeypatch.setattr(profiling, "spans", lambda a, b: [s for s in found
                                                          if s.start_ns >= a and s.end_ns <= b])
    trace = profiled.Trace(t0, t1, [("k", s, e) for s, e in device], [])
    return types.SimpleNamespace(trace=trace)


# window [0, 1000] ns; idle [0,100] [200,300] [500,800] [900,1000]: 60%
DEVICE = [(100, 200), (300, 500), (800, 900)]
SPANS = [_span("hmc.attempt", 10, 990, id_=1), _span("hmc.forward", 150, 400, parent=1, id_=2),
         _span("hmc.backward", 450, 850, parent=1, id_=3),
         _span("hmc.sync", 20, 30, parent=1, id_=4), _span("hmc.sync", 960, 980, parent=1, id_=5),
         _span("hmc.sync", 5, 8, id_=6), _span("hmc.forward", 0, 1000, thread=2, id_=7)]


def test_exact_values_on_a_hand_made_trace(monkeypatch):
    """Forward idles over [200, 300], backward over [500, 800], the rest of
    the idle ([0, 100] and [900, 1000]) is the loop's; the forward span of another
    thread counts for nothing."""
    ctx = _context(DEVICE, SPANS, monkeypatch)
    assert device_idle_pct.read(ctx) == pytest.approx(60.0)
    assert [m.read(ctx) for m in IDLE] == pytest.approx([10.0, 30.0, 20.0])
    assert host_syncs_per_attempt.read(ctx) == 3.0


@pytest.mark.parametrize("device", [DEVICE, [(0, 1000)], [(0, 10), (995, 1000)],
                                    [(140, 160), (160, 455), (700, 701), (840, 1200)]])
def test_idle_shares_add_up_to_device_idle(monkeypatch, device):
    ctx = _context(device, SPANS, monkeypatch)
    assert sum(m.read(ctx) for m in IDLE) == pytest.approx(device_idle_pct.read(ctx), abs=1e-9)
    assert all(m.read(ctx) >= -1e-9 for m in IDLE)


def test_idle_by_innermost_span(monkeypatch):
    """The card test's breakdown: each span's self time over the idle,
    adding up to device_idle_pct."""
    ctx = _context(DEVICE, SPANS, monkeypatch)
    got = idle_by_innermost(ctx.trace, SPANS)
    assert got == pytest.approx({"hmc.backward": 30.0, "hmc.attempt": 15.0, "hmc.forward": 10.0,
                                 "hmc.sync": 3.3, "outside every span": 1.7})
    assert sum(got.values()) == pytest.approx(device_idle_pct.read(ctx))


def test_no_reading_without_spans(monkeypatch):
    """A program without profiling.spans, a window the record no longer
    covers (None), or a window with no attempt: every reader is silent."""
    ctx = _context(DEVICE, SPANS, monkeypatch)
    for found in (None, [], [s for s in SPANS if s.name != "hmc.attempt"]):
        monkeypatch.setattr(profiling, "spans", lambda a, b, f=found: f)
        assert [m.read(ctx) for m in IDLE + (host_syncs_per_attempt,)] == [None] * 4
    monkeypatch.delattr(profiling, "spans")
    assert [m.read(ctx) for m in IDLE + (host_syncs_per_attempt,)] == [None] * 4


@pytest.mark.parametrize("kind,syncs", [("ffhq_adm", 4), ("ffhq_ldm", 3)])
def test_tiny_cells_traced_on_the_cpu(kind, syncs):
    """drive's round and live checks, the momentum mass's copy to the
    device, and the pixel sampler's check for samples to write; no device,
    so no idle share."""
    cell = tiny.cell(kind, chains=2)
    out = run.run_cell(cell, SEED, 0.1, 1, CPU)
    line = run.result_line(cell, out, 1, CPU)
    assert line["metrics"]["host_syncs_per_attempt"]["value"] == syncs
    assert line["metrics"]["host_syncs_per_attempt"]["unit"] == "syncs"
    assert not {"idle_fwd_pct", "idle_bwd_pct", "idle_loop_pct"} & set(line["metrics"])


def idle_by_innermost(trace, found) -> dict:
    """% of the window idle while each span name is the innermost span open
    on the attempt's thread (its self time), and outside every span."""
    thread = next(s.thread for s in found if s.name == "hmc.attempt")
    mine = [s for s in found if s.thread == thread]
    children = collections.defaultdict(list)
    for s in mine:
        children[s.parent].append((s.start_ns, s.end_ns))
    gaps, out = spans.idle(trace), collections.Counter()
    for s in mine:
        own, at = [], s.start_ns
        for a, b in sorted(children[s.id]):
            own += [(at, a)] if a > at else []
            at = max(at, b)
        own += [(at, s.end_ns)] if s.end_ns > at else []
        out[s.name] += spans.overlap(gaps, own)
    out["outside every span"] = sum(e - s for s, e in gaps) - sum(out.values())
    return {k: 100.0 * v / (trace.t1 - trace.t0) for k, v in out.most_common()}


@pytest.mark.card
@pytest.mark.parametrize("name", ["ffhq_adm.hmc8_inpaint", "ffhq_ldm.hmc8_inpaint_f32"])
def test_card_syncs_lie_in_sync_spans(card, name):
    """One attempt after the warm-up, profiled with the device's activity
    only (as the benchmark's traced attempt) under sync debug mode "warn":
    each warning, timed when Python sees it, lies within an `hmc.sync` span
    of its thread. Prints the counts and the four readings."""
    cell = cells.load(name)
    program = systems.load(cell.config["system"]).Program(cell.config, cell.traffic, SEED, card)
    images = run.Images(cell, SEED, card, program.x_shape)
    y0, x_t = images(0)
    loss_fn = program.loss_fn(y0)
    run.warm_up(program, loss_fn, x_t, images)
    state, draws = program.init_state(x_t), images.draws(1)

    def stop(state, rnd):
        raise window.WindowClosed()

    def one():
        try:
            program.run(loss_fn, state, draws, stop)
        except window.WindowClosed:
            pass

    warned = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            warned.append((time.time_ns(), threading.get_ident(),
                           "".join(traceback.format_stack(limit=6)[:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trace = profiled.profile(one, host=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    found = profiling.spans(trace.t0, trace.t1)
    assert found, "no span recorded under the device-only profiler"
    syncs = [s for s in found if s.name == "hmc.sync"]
    before = [w for w in warned if w[0] < trace.t0]  # the profiler's own start
    warned = [w for w in warned if w[0] >= trace.t0]
    inside = lambda s, w: s.thread == w[1] and s.start_ns <= w[0] <= s.end_ns  # noqa: E731
    outside = [w for w in warned if not any(inside(s, w) for s in syncs)]
    ctx = types.SimpleNamespace(trace=trace)
    readings = {m.__name__.split(".")[-1]: m.read(ctx)
                for m in IDLE + (host_syncs_per_attempt, device_idle_pct)}
    print(f"\n{name}: {len(warned)} sync warnings in the window ({len(before)} before it), "
          f"{len(syncs)} hmc.sync spans ({sum(any(inside(s, w) for w in warned) for s in syncs)}"
          f" warned of), {sum(s.name == 'hmc.attempt' for s in found)} attempt; readings "
          f"{readings}; window {trace.window_s:.3f} s, busy {trace.busy_s:.3f} s", flush=True)
    for w in before + outside:
        print(f"{'before the window' if w in before else 'outside a sync span'}:\n{w[2]}")
    print("idle % of the window by the innermost span open on the attempt's thread: "
          + ", ".join(f"{k} {v:.3f}" for k, v in idle_by_innermost(trace, found).items()))
    assert not outside
    assert sum(readings[m.__name__.split(".")[-1]] for m in IDLE) == pytest.approx(
        readings["device_idle_pct"], abs=0.1)
    assert not {n for n, _, _ in trace.device} & SPAN_NAMES
    del program, state, loss_fn
    run.free(card)
