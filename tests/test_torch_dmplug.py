"""nshmc_tpu_torch.solvers.dmplug against nshmc_tpu.solvers.dmplug (optax
0.2.6): Adam's iterates and its early stop, and L-BFGS's per-step losses,
step counts and final iterates under the backtracking line search.
Tolerances: float32 iterates rtol 1e-5 on the analytic losses (L-BFGS's
final iterate atol 1e-4, see there); through the
tiny U-Net's 3-step decoder atol 1e-4 (tests/test_unet.py's bar, 2e-4,
halved: Adam's normalized step keeps the gradient's relative error)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nshmc_tpu.solvers import dmplug as jdmplug
from nshmc_tpu_torch.solvers import dmplug
from test_torch_hmc import _pixel_problem

torch.set_num_threads(2)

SHAPE = (1, 4, 4, 1)


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    w = rng.uniform(0.5, 3.0, SHAPE).astype(np.float32)
    return (lambda x: (torch.sum(torch.from_numpy(w) * (x - torch.from_numpy(t)) ** 2),
                       torch.tanh(x)),
            lambda x: (jnp.sum(jnp.asarray(w) * (x - jnp.asarray(t)) ** 2), jnp.tanh(x)))


def _least_squares(seed=1):
    """A small convex least-squares problem, ||A x - b||^2 over 16 unknowns."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((24, 16)).astype(np.float32) * rng.uniform(0.5, 2.0, 16).astype(
        np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    return (lambda x: (torch.sum((ta @ x.reshape(-1) - tb) ** 2), x),
            lambda x: (jnp.sum((ja @ x.reshape(-1) - jb) ** 2), x))


def _quartic(seed=2):
    """Convex but not quadratic, from far away: the line search backtracks."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    return (lambda x: (torch.sum((x - torch.from_numpy(t)) ** 4), x),
            lambda x: (jnp.sum((x - jnp.asarray(t)) ** 4), x))


def _x0(seed=3, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(SHAPE)).astype(np.float32)


def test_adam_iterates_match_optax():
    """Each of 20 Adam steps on a quadratic against optax.adam(1e-2)."""
    loss, _ = _quadratic()
    x = jnp.asarray(_x0())
    opt = optax.adam(1e-2)
    st = opt.init(x)
    w_t = _quadratic()[1]
    for k in range(1, 21):
        g = jax.grad(lambda v: w_t(v)[0])(x)
        upd, st = opt.update(g, st)
        x = optax.apply_updates(x, upd)
        got, _ = dmplug.dmplug_adam(loss, torch.from_numpy(_x0()),
                                    dmplug.DMPlugAdamConfig(max_steps=k))
        np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=1e-5, atol=1e-7,
                                   err_msg=f"step {k}")


@pytest.mark.parametrize("problem", ["quadratic", "pixel"])
def test_adam_matches_jax_solver(problem):
    """20 steps (no early stop): the final x_T and the decoded image of the
    last gradient evaluation."""
    if problem == "quadratic":
        loss, jloss = _quadratic()
        x0, atol = _x0(), 1e-6
    else:
        jl, tl = _pixel_problem()  # per-chain losses: one chain
        loss = lambda x: (lambda l, d: (l.sum(), d))(*tl(x))
        jloss = lambda x: jl(x[0])
        x0 = np.random.default_rng(4).standard_normal((1, 16, 16, 3)).astype(np.float32)
        atol = 1e-4
    jcfg = jdmplug.DMPlugAdamConfig(max_steps=20)
    jx, jdec = jax.jit(lambda v: jdmplug.dmplug_adam(jloss, v, jcfg))(jnp.asarray(x0))
    steps = []
    x, dec = dmplug.dmplug_adam(loss, torch.from_numpy(x0), dmplug.DMPlugAdamConfig(max_steps=20),
                                progress=lambda k, l: steps.append(l))
    assert len(steps) == 20 and steps[-1] < steps[0]
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(dec.numpy().reshape(np.shape(jdec)), np.asarray(jdec),
                               rtol=1e-5, atol=atol)


def test_adam_early_stop_step_matches_jax():
    """A decoder that saturates: the ring's variance grows while x_T
    approaches 1, falls to 0 once every image in the ring is the saturated
    one, and then cannot improve, so the run stops `patience` steps later
    at the same step in both (read off the final x_T, which moves about
    lr a step)."""
    def loss(x):
        return torch.sum((x - 5.0) ** 2), torch.clamp(x, max=1.0) ** 3

    def jloss(x):
        return jnp.sum((x - 5.0) ** 2), jnp.minimum(x, 1.0) ** 3

    x0 = np.full(SHAPE, 0.8, np.float32) + 0.01 * _x0()
    fields = dict(max_steps=400, buffer_size=4, patience=20)
    jx, _ = jax.jit(lambda v: jdmplug.dmplug_adam(jloss, v, jdmplug.DMPlugAdamConfig(**fields)))(
        jnp.asarray(x0))
    steps = []
    x, _ = dmplug.dmplug_adam(loss, torch.from_numpy(x0), dmplug.DMPlugAdamConfig(**fields),
                              progress=lambda k, l: steps.append(k))
    assert 20 < len(steps) < 400  # it stopped early
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5)
    again, _ = dmplug.dmplug_adam(loss, torch.from_numpy(x0),
                                  dmplug.DMPlugAdamConfig(**dict(fields, max_steps=len(steps) + 1)))
    assert torch.equal(again, x)  # no step was taken past the stop


@pytest.mark.parametrize("problem", ["quadratic", "least_squares", "quartic"])
def test_lbfgs_matches_jax_solver(problem):
    """Per-step losses (progress after each one-step chunk), the step count
    (on the quadratic a tolerance exit ends the run, elsewhere the budget),
    and the final x_T; on the quartic the line search must have
    backtracked."""
    loss, jloss = {"quadratic": _quadratic, "least_squares": _least_squares,
                   "quartic": _quartic}[problem]()
    x0 = _x0(scale=3.0 if problem == "quartic" else 1.0)
    budget = dict(epochs=1, max_inner=40, chunk=1)
    jtrail, trail = [], []
    jx, _ = jdmplug.dmplug_lbfgs(jloss, jnp.asarray(x0),
                                 progress=lambda s, l: jtrail.append((s, l)), **budget)
    calls = []

    def counted(x):
        calls.append(1)
        return loss(x)

    x, dec = dmplug.dmplug_lbfgs(counted, torch.from_numpy(x0),
                                 progress=lambda s, l: trail.append((s, l)), **budget)
    assert [s for s, _ in trail] == [s for s, _ in jtrail]
    np.testing.assert_allclose([l for _, l in trail], [l for _, l in jtrail], rtol=1e-5,
                               atol=1e-6)
    # near the optimum the memory pairs (s, y) are differences of nearly equal
    # float32 vectors, so the last steps carry rounding of the gradient's size
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-4)
    assert trail[-1][1] < trail[0][1]
    if problem == "quartic":
        # one trial a step and the first step's value and gradient at x0: any
        # further call is a backtracking trial
        assert len(calls) > len(trail) + 1
    elif problem == "quadratic":
        assert len(trail) < 40  # a tolerance exit ended it


def test_lbfgs_chunks_and_budget():
    """The budget epochs * max_inner is checked between chunks, as in the
    JAX solver, so a chunk may run past it."""
    loss, jloss = _least_squares(5)
    x0 = _x0()
    budget = dict(epochs=1, max_inner=5, chunk=3, tol_grad=0.0, tol_change=0.0)
    jtrail, trail = [], []
    jdmplug.dmplug_lbfgs(jloss, jnp.asarray(x0), progress=lambda s, l: jtrail.append(s), **budget)
    dmplug.dmplug_lbfgs(loss, torch.from_numpy(x0), progress=lambda s, l: trail.append(s),
                        **budget)
    assert trail == jtrail == [3, 6]
