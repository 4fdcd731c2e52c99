"""The DDIM decoder's CUDA graphs (nshmc_tpu_torch/sampling/graphs.py).

On the CPU: the decoder runs the eager ladder, with the ladder's own values
and gradients bit for bit, for CPU tensors, without grad, with a module hook
(nested anywhere in the network, the latent eps-net included) or a global
one, and for a model it cannot observe; with the card check stood in, the
same calls still never reach a capture, while the HMC oracle's call does;
and the replay Function's logic (a capture per key: shape or math flag; a
new capture when a weight's storage changes; the two most recently used
keys kept; `release` drops them; a backward after a later forward) on a
stand-in that runs the ladder eagerly behind the
graphs' interface.

On the card (marker `card`, skipped without one), at the flagship's shape
(8 x 256^2 x 3, the bf16 ADM U-Net), on the latent ladder (8 x 64^2 x 3,
the f32 eps-net, stop-gradient and full) and on Stable Diffusion 2.1-base's
(8 x 64^2 x 4, the bf16 conditional eps-net, whose context set_context
changes after the capture): graphed and eager give the same
bits of x_0, loss and gradient; two evaluations in a row leave the first's
outputs intact; each launch counter of ops/ advances per replay by the eager
count; a `load_state_dict` after the capture shows in the next replay; a
hook registered after the capture sends the next call down the eager path;
a backward after later forwards, of its shape and another, is its own
forward's.

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_ddim_graphs.py -q -m card   # on the chip

(`--noconftest`: tests/conftest.py sets up JAX, which the card's host does
not have; this file does not import it.)"""
import math
import os
import time
import types

import numpy as np
import pytest
import torch

from nshmc_tpu_torch.cli import build_pixel_model, load_config
from nshmc_tpu_torch.cli_latent import build_latent_model
from nshmc_tpu_torch.hmc import engine, latent
from nshmc_tpu_torch.models.nn import GroupNormSiLU
from nshmc_tpu_torch.operators import build_operator
from nshmc_tpu_torch.ops import launches
from nshmc_tpu_torch.sampling import graphs
from nshmc_tpu_torch.sampling.ddim import ddim_decode, make_decoder
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from nshmc_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


def random_weights(model, seed):
    """Seeded weights that keep every activation live: the layers the
    reference zero-initialises get small random weights."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        if p.dim() > 1:
            small = ".out_layers.3." in name or ".proj_out." in name or name.startswith("out.2.")
            sd[name] = torch.randn(p.shape, generator=g) * (
                (0.05 if small else 1.0) / math.sqrt(p[0].numel()))
        elif name.endswith("weight"):
            sd[name] = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
        else:
            sd[name] = 0.05 * torch.randn(p.shape, generator=g)
    return sd


def pixel_problem(config, device, bf16=False, chains=2, seed=0):
    """The pixel CLI's decoder and loss at a config, with seeded weights."""
    cfg = load_config(os.path.join(CONFIGS, config))
    model, _ = build_pixel_model(cfg, types.SimpleNamespace(ckpt="", bf16=bf16), device)
    model.load_state_dict(random_weights(model, seed))
    d = cfg["diffusion"]
    sched = DiffusionSchedule.create(d["beta_schedule"], d["beta_start"], d["beta_end"],
                                     d["num_diffusion_timesteps"], device=device)
    seq = DDIMSequence.create(d["num_diffusion_timesteps"], 3)
    size = cfg["data"]["image_size"]
    op = build_operator("inpaint_random", 3, size, np.random.default_rng(seed), device=device)
    g = torch.Generator().manual_seed(seed + 1)
    y0 = op.H_img((2 * torch.rand(1, size, size, 3, generator=g) - 1).to(device))[0]
    x = torch.randn((chains, size, size, 3), generator=g).to(device)
    eager = lambda z: ddim_decode(model, sched, seq, z)  # noqa: E731
    return types.SimpleNamespace(
        model=model, net=model, decode=make_decoder(model, sched, seq), eager=eager, x=x,
        loss=lambda decode: engine.make_pixel_loss_fn(decode, op, y0))


def latent_problem(config, device, stop_gradient=True, chains=2, seed=0):
    """The latent CLI's decoder and loss at a config, with seeded weights."""
    cfg = load_config(os.path.join(CONFIGS, config))
    ldm, ucfg = build_latent_model(cfg, types.SimpleNamespace(ckpt=""), device)
    ldm.unet.load_state_dict(random_weights(ldm.unet, seed))
    ldm.first_stage.load_state_dict(random_weights(ldm.first_stage, seed + 1))
    seq = DDIMSequence.create(cfg["model"]["timesteps"], 3)
    fn = ldm.model_fn(stop_gradient=stop_gradient)
    size = cfg["data"]["image_size"]
    op = build_operator("inpaint_random", 3, size, np.random.default_rng(seed), device=device)
    g = torch.Generator().manual_seed(seed + 1)
    y0 = op.H_img((2 * torch.rand(1, size, size, 3, generator=g) - 1).to(device))[0]
    x = torch.randn((chains, ucfg.image_size, ucfg.image_size, ucfg.in_channels),
                    generator=g).to(device)
    eager = lambda z: ddim_decode(fn, ldm.schedule, seq, z)  # noqa: E731
    return types.SimpleNamespace(
        model=fn.module, net=ldm, decode=make_decoder(fn, ldm.schedule, seq), eager=eager, x=x,
        loss=lambda decode: latent.make_latent_loss_fn(decode, ldm.decode_first_stage, op, y0))


CPU_PROBLEMS = {
    "pixel": lambda: pixel_problem("tiny_test.yaml", CPU),
    "latent": lambda: latent_problem("tiny_latent_test.yaml", CPU),
    "latent_full_grad": lambda: latent_problem("tiny_latent_test.yaml", CPU,
                                               stop_gradient=False),
    "latent_sd": lambda: latent_problem("tiny_sd_test.yaml", CPU),
}


def assert_same(a, b):
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def value_and_grad(p, decode, x):
    return engine.value_and_grad(p.loss(decode), x)


def warm(p, x):
    """A key's first calls, which run eagerly: the next one captures."""
    for _ in range(graphs.WARMUP):
        value_and_grad(p, p.decode, x)


# ---------------------------------------------------------------------------
# CPU


class Captured(Exception):
    pass


def capture_refused(*args):
    raise Captured()


@pytest.fixture(params=sorted(CPU_PROBLEMS))
def problem(request):
    torch.manual_seed(0)
    return CPU_PROBLEMS[request.param]()


def test_cpu_calls_are_the_eager_ladder(problem):
    """CPU tensors: value, decoded output and gradient are the ladder's own
    bits, and so is a call without grad."""
    p = problem
    assert_same(value_and_grad(p, p.decode, p.x), value_and_grad(p, p.eager, p.x))
    with torch.no_grad():
        assert torch.equal(p.decode(p.x), p.eager(p.x))
    assert not p.decode.graphs


def test_decoder_sees_the_network(problem):
    assert problem.decode.module is problem.model
    assert graphs.observe(problem.model) is not None


@pytest.mark.parametrize("case", ["no_grad", "no_requires_grad", "module_hook", "pre_hook",
                                  "global_hook", "unobserved"])
def test_eager_cases_never_capture(problem, monkeypatch, case):
    """With the card check stood in for, the HMC oracle's call reaches a
    capture, and each of these runs the eager ladder instead, with its bits."""
    p = problem
    monkeypatch.setattr(graphs, "_card", lambda x: True)
    monkeypatch.setattr(graphs, "_Graphs", capture_refused)
    warm(p, p.x)
    x = p.x.detach().requires_grad_(True)
    with pytest.raises(Captured):
        p.decode(x)
    decode, handles = p.decode, []
    nested = [m for m in p.model.modules() if isinstance(m, GroupNormSiLU)][-1]
    if case == "no_requires_grad":
        x = p.x
    elif case == "module_hook":
        handles.append(nested.register_forward_hook(lambda *a: None))
    elif case == "pre_hook":
        handles.append(nested.register_forward_pre_hook(lambda *a: None))
    elif case == "global_hook":
        handles.append(torch.nn.modules.module.register_module_forward_hook(lambda *a: None))
    elif case == "unobserved":
        decode = graphs.Decoder(p.decode.ladder, None)
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            assert torch.equal(decode(x), p.eager(x))
    finally:
        for h in handles:
            h.remove()
    with pytest.raises(Captured):  # and back on the graphs' path without the hook
        p.decode(p.x.detach().requires_grad_(True))


def test_dispatch_mode_sees_the_eager_ladder(problem, monkeypatch):
    """Under a Python dispatch mode (profiling.compiled_flops' counter) a
    call on the card runs the eager ladder, so the mode counts its ops."""
    p = problem
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    card = graphs._card
    monkeypatch.setattr(graphs, "_card", lambda x: card(on_card))
    monkeypatch.setattr(graphs, "_Graphs", capture_refused)
    want = profiling.compiled_flops(lambda: value_and_grad(p, p.eager, p.x))
    assert profiling.compiled_flops(lambda: value_and_grad(p, p.decode, p.x)) == want > 0
    warm(p, p.x)
    with pytest.raises(Captured):
        p.decode(p.x.detach().requires_grad_(True))


def test_hook_inside_the_latent_eps_net():
    """A hook on a module nested in the latent eps-net (which the decoder
    sees through `model_fn(...).module`) is found; one on the VQ decoder,
    which the ladder does not call, is not the decoder's business."""
    p = latent_problem("tiny_latent_test.yaml", CPU)
    deep = [m for m in p.model.modules() if isinstance(m, GroupNormSiLU)]
    assert len(deep) > 2 and graphs.observe(p.decode.module) is not None
    h = deep[len(deep) // 2].register_forward_hook(lambda *a: None)
    try:
        assert graphs.observe(p.decode.module) is None
    finally:
        h.remove()
    vq = [m for m in p.net.first_stage.modules() if isinstance(m, GroupNormSiLU)][0]
    h = vq.register_forward_hook(lambda *a: None)
    try:
        assert graphs.observe(p.decode.module) is not None
    finally:
        h.remove()


class StandIn:
    """The interface of graphs._Graphs, run eagerly on the CPU: a static
    output and activations that each forward overwrites."""
    made = []

    def __init__(self, ladder, x, weights):
        self.ladder, self.weights, self.replays = ladder, weights, 0
        self.x0 = torch.empty_like(x)
        StandIn.made.append(self)

    def forward(self, x):
        with torch.enable_grad():
            self.leaf = x.detach().clone().requires_grad_(True)
            self.out = self.ladder(self.leaf)
        self.x0.copy_(self.out.detach())
        self.replays += 1
        return self.replays

    def backward(self, g):
        (dx,) = torch.autograd.grad(self.out, self.leaf, g)
        return dx.clone()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_card", lambda x: True)
    monkeypatch.setattr(graphs, "_Graphs", StandIn)
    StandIn.made = []
    return StandIn


def test_replay_function(problem, stand_in):
    """Through the replay Function: the eager bits; one capture a shape;
    the caller's outputs are its own; a backward after a later forward is
    the backward of its own forward."""
    p = problem
    want = value_and_grad(p, p.eager, p.x)
    for _ in range(graphs.WARMUP):  # the warm-up: eager calls, with the ladder's bits
        assert_same(value_and_grad(p, p.decode, p.x), want)
    assert not stand_in.made
    assert_same(value_and_grad(p, p.decode, p.x), want)
    assert_same(value_and_grad(p, p.decode, p.x), want)
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 2
    warm(p, p.x[:1])
    value_and_grad(p, p.decode, p.x[:1])
    assert len(stand_in.made) == 2 and len(p.decode.graphs) == 2
    x1, x2 = (p.x.detach().clone().requires_grad_(True) for _ in range(2))
    with torch.no_grad():
        x2 += 0.5
    out1, out2 = p.decode(x1), p.decode(x2)
    assert not torch.equal(out1, out2) and torch.equal(out1, p.eager(x1.detach()))
    (g1,) = torch.autograd.grad((out1 ** 2).sum(), x1)
    leaf = x1.detach().requires_grad_(True)
    (want1,) = torch.autograd.grad((p.eager(leaf) ** 2).sum(), leaf)
    assert torch.equal(g1, want1)


def test_new_storage_recaptures(problem, stand_in):
    """An in-place load_state_dict keeps the capture; a parameter given new
    storage makes a new one; replays see the weights either way."""
    p = problem
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)
    sd = {k: v + 0.01 for k, v in p.model.state_dict().items()}
    p.model.load_state_dict(sd)
    assert_same(value_and_grad(p, p.decode, p.x), value_and_grad(p, p.eager, p.x))
    assert len(stand_in.made) == 1
    w = next(p.model.parameters())
    w.data = w.data.clone()
    assert_same(value_and_grad(p, p.decode, p.x), value_and_grad(p, p.eager, p.x))
    assert len(stand_in.made) == 2 and len(p.decode.graphs) == 1


@pytest.mark.parametrize("new_shape", [False, True])
def test_context_is_a_graph_input(stand_in, new_shape):
    """A conditional eps-net's context, copied in place by set_context, is
    read by the next replay without a new capture; a context of another
    shape (a new buffer) makes a new one."""
    p = latent_problem("tiny_sd_test.yaml", CPU)
    warm(p, p.x)
    old = value_and_grad(p, p.decode, p.x)
    tokens = p.net.model.context.shape[1] + (2 if new_shape else 0)
    p.net.set_context(torch.randn((1, tokens, 24), generator=torch.Generator().manual_seed(5)))
    got = value_and_grad(p, p.decode, p.x)
    assert_same(got, value_and_grad(p, p.eager, p.x))
    assert not torch.equal(got[1], old[1])
    assert len(stand_in.made) == (2 if new_shape else 1)


@pytest.mark.parametrize("change", ["cudnn_off", "deterministic", "matmul_tf32", "shape"])
def test_what_makes_a_new_capture(problem, stand_in, monkeypatch, change):
    """A replay runs what its capture found: a math flag or a new shape
    captures anew; the decoder keeps the two most recently used keys."""
    p = problem
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)
    x = p.x
    if change == "cudnn_off":
        monkeypatch.setattr(torch.backends.cudnn, "enabled", False)
    elif change == "deterministic":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    elif change == "matmul_tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    else:
        x = p.x[:1]
    warm(p, x)
    assert len(stand_in.made) == 1
    assert_same(value_and_grad(p, p.decode, x), value_and_grad(p, p.eager, x))
    assert len(stand_in.made) == 2 and len(p.decode.graphs) == 2
    warm(p, torch.cat([p.x, p.x]))
    value_and_grad(p, p.decode, torch.cat([p.x, p.x]))  # a third key: the oldest goes
    assert len(stand_in.made) == 3 and len(p.decode.graphs) == graphs.KEEP == 2
    assert stand_in.made[0] not in p.decode.graphs.values()
    value_and_grad(p, p.decode, x)  # the second key, still kept
    assert len(stand_in.made) == 3


def test_release_drops_the_graphs(problem, stand_in):
    """`release` drops every key's graphs: the next calls warm up again,
    with the eager bits, and then capture anew."""
    p = problem
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)
    assert len(p.decode.graphs) == 1
    p.decode.release()
    assert not p.decode.graphs
    want = value_and_grad(p, p.eager, p.x)
    for _ in range(graphs.WARMUP):
        assert_same(value_and_grad(p, p.decode, p.x), want)
    assert len(stand_in.made) == 1
    assert_same(value_and_grad(p, p.decode, p.x), want)
    assert len(stand_in.made) == 2 and len(p.decode.graphs) == 1


def test_replay_span(problem, stand_in):
    """Under a profiler each forward replay is one `ddim.replay` span inside
    the evaluation's `hmc.forward`; an eager call records none."""
    from torch.profiler import ProfilerActivity, profile

    p = problem
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        value_and_grad(p, p.decode, p.x)
        value_and_grad(p, p.eager, p.x)
        t1 = time.time_ns()
    found = profiling.spans(t0, t1)
    names = [s.name for s in found]
    assert names.count(graphs.REPLAY_SPAN) == 1 and names.count("hmc.forward") == 2
    replay = next(s for s in found if s.name == graphs.REPLAY_SPAN)
    forward = next(s for s in found if s.id == replay.parent)
    assert forward.name == "hmc.forward"


def test_backward_root_hands_the_cotangent_through():
    """The backward graph's scalar root gives the gradient that a backward
    given the cotangent gives, bit for bit."""
    g_ = torch.Generator().manual_seed(3)
    leaf = torch.randn((2, 8, 8, 3), generator=g_).requires_grad_(True)
    x0 = torch.clamp(leaf * 1.7 - 0.2, -1.0, 1.0) / 0.3
    g = torch.randn(x0.shape, generator=g_)
    (got,) = torch.autograd.grad(graphs._Cotangent.apply(x0, g), leaf, retain_graph=True)
    (want,) = torch.autograd.grad(x0, leaf, g)
    assert torch.equal(got, want)


def test_launch_counters_advance(monkeypatch):
    """ops/launches.py reads and advances every counter of the set."""
    from nshmc_tpu_torch.ops import attention, groupnorm

    before = launches.read()
    assert {"group_stats", "normalize_silu", "groupnorm_silu_backward", "launch_one",
            "launch_twopass", "attention_forward", "attn_fwd_tc_kernel",
            "attn_fwd_f32_kernel", "attn_fwd_tc_long"} == set(before)
    launches.advance({k: i + 1 for i, k in enumerate(before)})
    moved = launches.since(before)
    try:
        assert moved == {k: i + 1 for i, k in enumerate(before)}
        assert groupnorm.channel_stats.launches == before["group_stats"] + 1
        assert attention.KERNEL_LAUNCHES[torch.float32].launches == \
            before["attn_fwd_f32_kernel"] + moved["attn_fwd_f32_kernel"]
        assert attention.LONG_LAUNCHES.launches == \
            before["attn_fwd_tc_long"] + moved["attn_fwd_tc_long"]
    finally:
        launches.advance({k: -n for k, n in moved.items()})
    assert launches.read() == before


# ---------------------------------------------------------------------------
# the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host: the test runs on the chip")
    return torch.device("cuda", 0)


CARD_PROBLEMS = {
    "flagship": lambda dev: pixel_problem("ffhq.yaml", dev, bf16=True, chains=8),
    "sd21_base": lambda dev: latent_problem("sd21_base_latent.yaml", dev, chains=8),
    "latent": lambda dev: latent_problem("ffhq_latent.yaml", dev, chains=8),
    "latent_full_grad": lambda dev: latent_problem("ffhq_latent.yaml", dev,
                                                   stop_gradient=False, chains=8),
}


@pytest.fixture(scope="module", params=sorted(CARD_PROBLEMS))
def on_card(request, card):
    p = CARD_PROBLEMS[request.param](card)
    yield p
    del p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _replays(p):
    return sum(g.replays for g in p.decode.graphs.values())


@pytest.mark.card
def test_card_graphed_equals_eager(on_card):
    """The same bits of loss, x_0 and gradient: at the capture's call and at
    a plain replay; differences printed if not."""
    p = on_card
    want = value_and_grad(p, p.eager, p.x)
    for _ in range(graphs.WARMUP + 2):  # eager warm-up calls, the capture's, a replay
        got = value_and_grad(p, p.decode, p.x)
        diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        print(f"graphed - eager, max |diff| of loss, x_0, gradient: {diffs}")
        assert_same(got, want)
    assert len(p.decode.graphs) == 1 and _replays(p) == 2


@pytest.mark.card
def test_card_outputs_stay_the_callers(on_card):
    p = on_card
    warm(p, p.x)
    first = value_and_grad(p, p.decode, p.x)
    kept = [t.clone() for t in first]
    second = value_and_grad(p, p.decode, p.x + 0.25)
    assert_same(first, kept)
    assert not torch.equal(first[2], second[2])
    x1 = p.x.detach().clone().requires_grad_(True)
    x2 = (p.x + 0.25).requires_grad_(True)
    x3 = p.x[:4].detach().clone().requires_grad_(True)  # another key
    warm(p, x3)
    out1, out2, out3 = p.decode(x1), p.decode(x2), p.decode(x3)
    (g1,) = torch.autograd.grad(out1.square().sum(), x1)  # after two later forwards
    leaf = x1.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(p.eager(leaf).square().sum(), leaf)
    assert torch.equal(out1, p.eager(x1.detach())) and torch.equal(g1, want)


@pytest.mark.card
def test_card_counters_advance_per_replay(on_card):
    p = on_card
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)  # captured, if not already
    torch.cuda.synchronize()
    before = launches.read()
    value_and_grad(p, p.eager, p.x)
    eager = launches.since(before)
    before = launches.read()
    n = _replays(p)
    value_and_grad(p, p.decode, p.x)
    assert _replays(p) == n + 1
    assert launches.since(before) == eager
    assert eager["group_stats"] > 0 and sum(eager.values()) > eager["group_stats"]


@pytest.mark.card
def test_card_new_weights_show(on_card):
    p = on_card
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)
    n, old = len(p.decode.graphs), {k: v.clone() for k, v in p.model.state_dict().items()}
    try:
        p.model.load_state_dict(random_weights(p.model, 7))
        got = value_and_grad(p, p.decode, p.x)
        assert len(p.decode.graphs) == n
        assert_same(got, value_and_grad(p, p.eager, p.x))
    finally:
        p.model.load_state_dict(old)
    assert_same(value_and_grad(p, p.decode, p.x), value_and_grad(p, p.eager, p.x))


@pytest.fixture(scope="module")
def sd_on_card(card):
    p = CARD_PROBLEMS["sd21_base"](card)
    yield p
    del p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@pytest.mark.card
def test_card_context_is_a_graph_input(sd_on_card):
    """After set_context(new), a replay of the captured graphs gives the
    eager ladder's bits with the new context, not the captured one's."""
    p = sd_on_card
    warm(p, p.x)
    captured = p.net.model.context.clone()
    old = value_and_grad(p, p.decode, p.x)  # the capture's call
    graphs_before, n = dict(p.decode.graphs), _replays(p)
    new = torch.randn(captured.shape, generator=torch.Generator().manual_seed(9)).to(p.x.device)
    try:
        p.net.set_context(new)
        got = value_and_grad(p, p.decode, p.x)
        assert p.decode.graphs == graphs_before and _replays(p) == n + 1
        want = value_and_grad(p, p.eager, p.x)
        diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        print(f"replay after set_context - eager, max |diff| of loss, z_0, gradient: {diffs}")
        assert_same(got, want)
        assert not torch.equal(got[1], old[1])
    finally:
        p.net.set_context(captured)
    assert_same(value_and_grad(p, p.decode, p.x), old)


@pytest.mark.card
def test_card_hook_sends_eager(on_card):
    p = on_card
    warm(p, p.x)
    value_and_grad(p, p.decode, p.x)
    n = _replays(p)
    calls = []
    nested = [m for m in p.model.modules() if isinstance(m, GroupNormSiLU)][-1]
    h = nested.register_forward_hook(lambda *a: calls.append(1))
    try:
        got = value_and_grad(p, p.decode, p.x)
    finally:
        h.remove()
    assert calls and _replays(p) == n
    assert_same(got, value_and_grad(p, p.eager, p.x))
    value_and_grad(p, p.decode, p.x)  # the hook gone, back to the graphs
    assert _replays(p) == n + 1
