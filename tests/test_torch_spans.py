"""The sampler's spans (nshmc_tpu_torch/utils/profiling.py::span) on the CPU:
nothing is recorded without a profiler; under one, an MH attempt of the tiny
pixel and latent samplers (configs/tiny_test.yaml, tiny_latent_test.yaml)
records exactly its tree of spans, on the profiler's clock, and adds no
event to the profiler's own trace; the record is bounded and says when it
no longer covers a window."""
import collections
import os
import time
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from nshmc_tpu_torch.cli import build_pixel_model, load_config
from nshmc_tpu_torch.cli_latent import build_latent_model
from nshmc_tpu_torch.hmc import engine, latent
from nshmc_tpu_torch.operators import build_operator
from nshmc_tpu_torch.sampling.ddim import make_decoder
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from nshmc_tpu_torch.utils import profiling

torch.set_num_threads(2)

CPU = torch.device("cpu")
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
TAU, EPS = 0.1, 0.05
L = 2  # floor(TAU / EPS) leapfrog steps
NAMES = ("hmc.attempt", "hmc.sync", "hmc.leapfrog_step", "hmc.forward", "hmc.backward",
         "ddim.step", "ddim.model", "operator", "vq.decode")


def _operator_and_y0(size):
    op = build_operator("inpaint_random", 3, size, np.random.default_rng(0), device=CPU)
    y0 = op.H_img(torch.rand(1, size, size, 3, generator=torch.Generator().manual_seed(1)))[0]
    return op, y0


@pytest.fixture(scope="module")
def pixel():
    cfg = load_config(os.path.join(CONFIGS, "tiny_test.yaml"))
    model, _ = build_pixel_model(cfg, types.SimpleNamespace(ckpt="", bf16=False), CPU)
    d = cfg["diffusion"]
    sched = DiffusionSchedule.create(d["beta_schedule"], d["beta_start"], d["beta_end"],
                                     d["num_diffusion_timesteps"], device=CPU)
    decode = make_decoder(model, sched, DDIMSequence.create(d["num_diffusion_timesteps"], 3))
    op, y0 = _operator_and_y0(cfg["data"]["image_size"])
    hcfg = engine.HMCConfig(tau=TAU, epsilon=EPS, max_attempts=1)
    loss_fn = engine.make_pixel_loss_fn(decode, op, y0)

    def run(chains=2, chain_chunk=0):
        gen = torch.Generator().manual_seed(2)
        state = engine.init_chains(hcfg, chains, (16, 16, 3), CPU, gen)
        return engine.run_hmc(loss_fn, hcfg, state, gen, chain_chunk=chain_chunk)
    return run


@pytest.fixture(scope="module")
def latent_sampler():
    cfg = load_config(os.path.join(CONFIGS, "tiny_latent_test.yaml"))
    ldm, ucfg = build_latent_model(cfg, types.SimpleNamespace(ckpt=""), CPU)
    decode_z = make_decoder(ldm.model_fn(stop_gradient=True), ldm.schedule,
                            DDIMSequence.create(cfg["model"]["timesteps"], 3))
    op, y0 = _operator_and_y0(cfg["data"]["image_size"])
    lcfg = latent.LatentHMCConfig(tau=TAU, epsilon=EPS, epochs=1, sampling=0)
    loss_fn = latent.make_latent_loss_fn(decode_z, ldm.decode_first_stage, op, y0)
    shape = (ucfg.image_size, ucfg.image_size, ucfg.in_channels)

    def run(chains=2, chain_chunk=0):
        gen = torch.Generator().manual_seed(2)
        state = latent.init_latent_chains(lcfg, chains, shape, CPU, gen)
        return latent.run_latent_hmc(loss_fn, lcfg, state, gen, chain_chunk=chain_chunk)
    return run


def _sampler(request, kind):
    return request.getfixturevalue({"pixel": "pixel", "latent": "latent_sampler"}[kind])


def _traced(fn, record=profiling.spans):
    """fn() under a CPU profiler: (its spans, the profiler's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        fn()
        t1 = time.time_ns()
    return record(t0, t1), list(prof.profiler.kineto_results.events())


def _edges(spans):
    """Counter of (span, its parent's name) over the spans."""
    by_id = {s.id: s for s in spans}
    return collections.Counter((s.name, by_id[s.parent].name if s.parent else None)
                               for s in spans)


def _expected(kind, waves=1):
    """One attempt's tree: drive's round check outside the attempt; inside
    it, the live check, and once a wave the momentum mass's copy to the
    device and the pixel sampler's check for samples to write."""
    evals = waves * (L + 1)
    tree = {("hmc.attempt", None): 1, ("hmc.sync", None): 1,
            ("hmc.sync", "hmc.attempt"): 1 + waves * (2 if kind == "pixel" else 1),
            ("hmc.leapfrog_step", "hmc.attempt"): waves * L,
            ("hmc.forward", "hmc.attempt"): waves, ("hmc.forward", "hmc.leapfrog_step"): waves * L,
            ("hmc.backward", "hmc.attempt"): waves,
            ("hmc.backward", "hmc.leapfrog_step"): waves * L,
            ("ddim.step", "hmc.forward"): 3 * evals, ("ddim.model", "ddim.step"): 3 * evals,
            ("operator", "hmc.forward"): evals}
    if kind == "latent":
        tree[("vq.decode", "hmc.forward")] = evals
    return tree


@pytest.mark.parametrize("kind", ["pixel", "latent"])
def test_nothing_is_recorded_without_a_profiler(request, kind):
    run = _sampler(request, kind)
    t0 = time.time_ns()
    run()
    assert profiling.spans(t0, time.time_ns()) == []


@pytest.mark.parametrize("kind", ["pixel", "latent"])
def test_an_attempt_records_its_tree(request, kind):
    spans, _ = _traced(_sampler(request, kind))
    assert dict(_edges(spans)) == _expected(kind)
    (attempt,) = [s for s in spans if s.name == "hmc.attempt"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.thread == attempt.thread
        outside = s.name == "hmc.sync" and s.parent is None  # drive's round check
        assert s.attempt == (None if outside else attempt.id), s
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)


@pytest.mark.parametrize("kind", ["pixel", "latent"])
def test_waves_share_one_attempt(request, kind):
    """Two waves of chains (`chain_chunk`): each runs its own trajectory
    inside the one attempt."""
    spans, _ = _traced(lambda: _sampler(request, kind)(chains=4, chain_chunk=2))
    assert dict(_edges(spans)) == _expected(kind, waves=2)


def test_spans_add_no_event_to_the_trace(pixel):
    spans, events = _traced(pixel)
    assert spans
    assert not {e.name() for e in events} & set(NAMES)


def test_an_attempts_convolutions_lie_in_its_model_spans(pixel):
    """Shared clock: every forward convolution the profiler saw in the
    attempt lies within one of the `ddim.model` spans (the U-Net's calls)."""
    spans, events = _traced(pixel)
    model = [(s.start_ns, s.end_ns) for s in spans if s.name == "ddim.model"]
    convs = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.name() == "aten::convolution"]
    assert len(model) == 3 * (L + 1) and convs
    for a, b in convs:
        assert any(s <= a and b <= e for s, e in model), (a, b)


def test_spans_share_the_profilers_clock():
    """Each aten op run inside a span lies within that span's [start, end]."""
    a, x, w = torch.ones(64, 64), torch.ones(1, 3, 16, 16), torch.ones(4, 3, 3, 3)

    def fn():
        with profiling.span("mm"):
            a @ a
        torch.ones(8).cumsum(0)
        with profiling.span("conv"):
            F.conv2d(x, w)

    spans, events = _traced(fn)
    by_name = {s.name: s for s in spans}
    for name, op in (("mm", "aten::mm"), ("conv", "aten::conv2d")):
        found = [e for e in events if e.name() == op]
        s = by_name[name]
        assert found and all(s.start_ns <= e.start_ns() and
                             e.start_ns() + e.duration_ns() <= s.end_ns for e in found), op


def test_the_record_drops_its_oldest_spans():
    rec = profiling.SpanRecord(limit=4)
    marks = []

    def fn():
        for i in range(6):
            marks.append(time.time_ns())
            with rec.span(f"s{i}"):
                pass
        marks.append(time.time_ns())

    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    assert [s.name for s in rec.within(marks[2], marks[-1])] == ["s2", "s3", "s4", "s5"]
    assert rec.within(marks[1], marks[-1]) is None  # s1 was dropped
    assert rec.within(marks[0], marks[-1]) is None
    assert [s.name for s in rec.within(marks[4], marks[-1])] == ["s4", "s5"]


def test_a_span_closes_on_an_exception():
    rec = profiling.SpanRecord()

    def fn():
        with rec.span("outer", attempt=True):
            with pytest.raises(ValueError):
                with rec.span("inner"):
                    raise ValueError
        with rec.span("after"):
            pass

    spans, _ = _traced(fn, rec.within)
    by_name = {s.name: s for s in spans}
    assert by_name["inner"].parent == by_name["outer"].id
    assert by_name["inner"].attempt == by_name["outer"].id
    assert by_name["after"].parent is None and by_name["after"].attempt is None
