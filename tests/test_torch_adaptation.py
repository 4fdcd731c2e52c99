"""nshmc_tpu_torch.hmc.adaptation against nshmc_tpu.hmc.adaptation: the
variance rank scores, the dual-averaging recursion and its lockstep driver,
the leapfrog with a diagonal metric and Welford statistics, and the
mass-conditioned sampler, with the JAX key chain's draws replayed into the
port (tests/_torch_hmc_draws.py). Tolerances: integers and decisions exact,
float32 state rtol 1e-5 on the quadratic loss (a few float32 operations
apart), the tiny U-Net's states atol 1e-4 as tests/test_torch_hmc.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.hmc import adaptation as jada
from nshmc_tpu.hmc import engine as jeng
from nshmc_tpu_torch.hmc import adaptation, engine
from _torch_hmc_draws import chain_draws, replay_draws
from test_torch_hmc import SHAPE as PIXEL_SHAPE
from test_torch_hmc import _pixel_problem, _quadratic

torch.set_num_threads(2)

QSHAPE = (4, 4, 1)


def _quadratic_problem(seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(-1, 1, QSHAPE).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, QSHAPE).astype(np.float32)
    return _quadratic(target, weight)


def _assert_states(out, jout, ints, floats, arrays, rtol=1e-5, atol=1e-5):
    for name in ints:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                      err_msg=name)
    for name in floats:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-6, err_msg=name)
    for name in arrays:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_rank_scores_match_jax_exactly_with_ties():
    """Ties (repeated values, zero-variance entries) rank in index order in
    both, as the sorts are stable."""
    rng = np.random.default_rng(0)
    v = rng.integers(0, 5, (3, 4, 4, 2)).astype(np.float32)
    v[1] = 0.0  # a chain whose variance is zero everywhere
    v[2, :2] = rng.standard_normal((2, 4, 2)).astype(np.float32) ** 2
    got = adaptation._rank_scores(torch.from_numpy(v)).numpy()
    for c in range(3):
        np.testing.assert_array_equal(got[c], np.asarray(jada._rank_scores(jnp.asarray(v[c]))))
    assert got.min() == -1.0 and got.max() == 1.0


def test_dual_averaging_update_matches_jax():
    rng = np.random.default_rng(1)
    probs = rng.uniform(0, 1, 50).astype(np.float32)
    da, jda = adaptation.DualAveragingState.create(0.05, device="cpu"), \
        jada.DualAveragingState.create(0.05)
    for p in probs:
        da = adaptation.dual_averaging_update(da, torch.tensor(p), target=0.65)
        jda = jada.dual_averaging_update(jda, jnp.float32(p), target=0.65)
        for name in ("log_eps", "log_eps_avg", "h_sum", "mu"):
            np.testing.assert_allclose(float(getattr(da, name)), float(getattr(jda, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        assert int(da.t) == int(jda.t)
    assert da.log_eps.dtype == torch.float32


def test_leapfrog_with_mass_and_welford_matches_jax():
    """The diagonal metric scales the momentum draw, the kinetic energy and
    the position step; the Welford mean and M2 follow the L positions."""
    jloss, loss = _quadratic_problem(2)
    rng = np.random.default_rng(3)
    n, n_leapfrog = 3, 4
    x = rng.standard_normal((n,) + QSHAPE).astype(np.float32)
    mass = np.exp(rng.uniform(-1, 1, (n,) + QSHAPE)).astype(np.float32)
    sigma, eps = np.float32(0.4), np.float32(0.15)
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    jout = jax.vmap(lambda xi, ki, mi: jeng.leapfrog_propose(
        jloss, xi, sigma, eps, n_leapfrog, key=ki, mass_diag=mi, collect_welford=True))(
        jnp.asarray(x), keys, jnp.asarray(mass))
    p0, u = [], []
    for k in keys:  # leapfrog_propose's own split of its key
        k_mom, k_acc = jax.random.split(k)
        p0.append(np.asarray(jax.random.normal(k_mom, QSHAPE, jnp.float32)))
        u.append(float(jax.random.uniform(k_acc)))
    out = engine.leapfrog_propose(
        loss, torch.from_numpy(x), torch.full((n,), sigma), torch.full((n,), eps), n_leapfrog,
        p0=torch.from_numpy(np.stack(p0)), u=torch.tensor(u), mass_diag=torch.from_numpy(mass),
        collect_welford=True)
    accept, xp, dec, lval, log_ratio, (mean, m2) = out
    jaccept, jxp, jdec, jl, jlr, (jmean, jm2) = jout
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jaccept))
    for a, b in ((xp, jxp), (dec, jdec), (lval, jl), (log_ratio, jlr), (mean, jmean), (m2, jm2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert float(m2.abs().max()) > 0


@pytest.mark.parametrize("problem", ["quadratic", "pixel"])
def test_run_hmc_dual_averaging_matches_jax(problem):
    """Lockstep rounds with the shared step size: the eps of the annealing
    chains after every round (against JAX runs cut after that many rounds),
    the final states and the dual-averaging state."""
    if problem == "quadratic":
        jloss, loss = _quadratic_problem(4)
        shape, n = QSHAPE, 4
        cfg = dict(sigma_0=0.3, tau=1.2, epsilon=0.6, epochs=3, sampling=1, max_attempts=12)
        cuts = (1, 4, 12)
    else:
        jloss, loss = _pixel_problem()
        shape, n = PIXEL_SHAPE, 2
        cfg = dict(sigma_0=0.2, tau=0.1, epsilon=0.05, epochs=1, sampling=1, max_attempts=3)
        cuts = (3,)  # one JAX compile of the tiny U-Net's loop: the final round
    tcfg = engine.HMCConfig(**cfg)
    key = jax.random.PRNGKey(11)
    x0, p0, u = replay_draws(key, n, shape, cfg["max_attempts"])
    trail = []
    state = engine.init_chains(tcfg, n, shape, device="cpu", x=torch.from_numpy(x0))
    out, da = adaptation.run_hmc_dual_averaging(
        loss, tcfg, state, draws=chain_draws(p0, u),
        callback=lambda s, d, r: trail.append((s.epsilon.clone(), float(d.log_eps))))
    for cut in cuts:
        jcfg = jeng.HMCConfig(**{**cfg, "max_attempts": cut})
        jout, jda = jax.jit(lambda s: jada.run_hmc_dual_averaging(jloss, jcfg, s))(
            jeng.init_chains(key, jcfg, n, shape))
        if cut > len(trail):
            continue
        eps, log_eps = trail[cut - 1]
        np.testing.assert_allclose(eps.numpy(), np.asarray(jout.epsilon), rtol=1e-5)
        np.testing.assert_allclose(log_eps, float(jda.log_eps), rtol=1e-5, atol=1e-6)
    assert len(trail) == int(da.t) == int(jda.t)
    for name in ("log_eps", "log_eps_avg", "h_sum"):
        np.testing.assert_allclose(float(getattr(da, name)), float(getattr(jda, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    atol = 1e-5 if problem == "quadratic" else 1e-4
    _assert_states(out, jout, ("epoch", "rejected", "attempts", "accepted"), (),
                   ("tau", "epsilon", "sigma_y", "x", "samples", "last_decoded"),
                   rtol=atol, atol=atol)
    # the shared eps moved away from its start while the chains annealed
    assert any(abs(float(e[0]) - cfg["epsilon"]) > 1e-4 for e, _ in trail)


def test_run_conditioned_hmc_matches_jax():
    """A whole conditioned run on the quadratic: the burn phase, mass
    updates past epochs // 3, the (post_tau, post_epsilon) switch, the
    backoff, and the sample buffer whose clipped index puts the last
    burn + 1 kept samples in its final slot."""
    jloss, loss = _quadratic_problem(6)
    cfg = dict(sigma_0=0.3, tau=1.2, epsilon=0.6, burn=1, epochs=3, sampling=1,
               max_attempts=40)
    jcfg, tcfg = jada.ConditionedHMCConfig(**cfg), adaptation.ConditionedHMCConfig(**cfg)
    n = 4
    key = jax.random.PRNGKey(13)
    jout = jax.jit(lambda s: jada.run_conditioned_hmc(jloss, jcfg, s))(
        jada.init_conditioned_chains(key, jcfg, n, QSHAPE))
    x0, p0, u = replay_draws(key, n, QSHAPE, cfg["max_attempts"])
    state = adaptation.init_conditioned_chains(tcfg, n, QSHAPE, device="cpu",
                                               x=torch.from_numpy(x0))
    out = adaptation.run_conditioned_hmc(loss, tcfg, state, draws=chain_draws(p0, u))
    _assert_states(out, jout, ("epoch", "rejected", "attempts", "accepted"),
                   ("tau", "epsilon"), ("x", "mass_diag", "samples", "last_decoded"))
    done = out.epoch.numpy() == tcfg.total_epochs
    assert done.any()
    assert (np.abs(out.mass_diag.numpy() - 1).reshape(n, -1).max(1) > 0.1).any()  # M adapted
    mass = out.mass_diag.numpy()
    assert mass.min() >= np.exp(-1) * (1 - 1e-6) and mass.max() <= np.exp(1) * (1 + 1e-6)
    # a finished chain's last sample sits in the final slot and equals its
    # last decoded proposal: the clip sent burn + 1 samples there
    c = int(np.flatnonzero(done)[0])
    np.testing.assert_array_equal(out.samples[c, -1].numpy(), out.last_decoded[c].numpy())
    assert out.samples.shape[1] == 3 * tcfg.sampling
