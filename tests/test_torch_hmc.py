"""The slice as a whole: nshmc_tpu_torch's pixel HMC (DDIM decode through the
tiny U-Net, inpainting operator, leapfrog + MH engine) against the JAX
engine, with the momentum and accept-uniform draws of the JAX key chain
replayed into the port (as tests/test_hmc_parity.py replays them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.hmc import engine as jeng
from nshmc_tpu.operators import build_operator as jax_build_operator
from nshmc_tpu.sampling.ddim import make_decoder as jax_make_decoder
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch.hmc import engine
from nshmc_tpu_torch.operators import build_operator
from nshmc_tpu_torch.sampling.ddim import make_decoder
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from _torch_hmc_draws import replay_draws
from test_torch_unet import jax_tiny, torch_tiny

torch.set_num_threads(2)

D = 16
SHAPE = (D, D, 3)


def _pixel_problem(seed=0):
    """Tiny U-Net, 3-step DDIM, 92% random inpainting, y0 = H(x_orig): the
    JAX loss (one chain) and the port's loss (a batch of chains)."""
    jmodel, params, cfg = jax_tiny(seed=seed)
    model = torch_tiny(params, cfg)
    jop = jax_build_operator("inpaint_random", 3, D, np.random.default_rng(seed))
    op = build_operator("inpaint_random", 3, D, np.random.default_rng(seed), device="cpu")
    x_orig = np.random.default_rng(seed + 1).uniform(-1, 1, (1,) + SHAPE).astype(np.float32)
    y0 = np.array(jop.H_img(jnp.asarray(x_orig)))[0]
    jdecode = jax_make_decoder(lambda x, t: jmodel.apply(params, x, t),
                               JaxSched.create(), JaxSeq.create(1000, 3))
    jloss = jeng.make_pixel_loss_fn(jdecode, jop, jnp.asarray(y0))
    decode = make_decoder(model, DiffusionSchedule.create(device="cpu"),
                          DDIMSequence.create(1000, 3))
    loss = engine.make_pixel_loss_fn(decode, op, torch.from_numpy(y0))
    return jloss, loss


def test_pixel_loss_and_grad_match_jax():
    jloss, loss = _pixel_problem()
    x = np.random.default_rng(5).standard_normal((2,) + SHAPE).astype(np.float32)
    (jl, jdec), jg = jax.vmap(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    l, dec, g = engine.value_and_grad(loss, torch.from_numpy(x))
    assert l.shape == (2,)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=2e-4, rtol=1e-3)
    g, jg = g.numpy(), np.asarray(jg)
    # three chained U-Net backward passes: compared as in test_torch_ddim
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 2e-4
    np.testing.assert_allclose(g, jg, rtol=1e-3, atol=2e-3 * np.abs(jg).max())


def test_three_attempts_match_jax_engine():
    """Three MH attempts, 2 chains, L=2: the same draws give the same
    trajectory, decisions, annealing and step-size state."""
    jloss, loss = _pixel_problem()
    cfg = dict(sigma_0=0.2, tau=0.1, epsilon=0.05, epochs=2, sampling=1)
    jcfg, tcfg = jeng.HMCConfig(**cfg), engine.HMCConfig(**cfg)
    assert tcfg.n_leapfrog == jcfg.n_leapfrog == 2
    key = jax.random.PRNGKey(42)
    jstate = jeng.init_chains(key, jcfg, 2, SHAPE)
    x0, p0, u = replay_draws(key, 2, SHAPE, 3)
    np.testing.assert_array_equal(np.asarray(jstate.x), x0)
    state = engine.init_chains(tcfg, 2, SHAPE, device="cpu", x=torch.from_numpy(x0))
    attempt = jax.jit(jax.vmap(lambda s: jeng.hmc_attempt(jloss, jcfg, s)))

    compared = 0
    for a in range(3):
        prev_epoch = np.asarray(jstate.epoch)
        jstate = attempt(jstate)
        state, log_ratio = engine.hmc_attempt(loss, tcfg, state, p0=torch.from_numpy(p0[a]),
                                              u=torch.from_numpy(u[a]))
        j_acc = np.asarray(jstate.epoch) > prev_epoch
        margin = np.abs(np.log(u[a]) - np.minimum(log_ratio.numpy(), 0.0))
        clear = margin > 1e-3
        np.testing.assert_array_equal((state.epoch.numpy() > prev_epoch)[clear], j_acc[clear])
        if not clear.all():
            break  # a borderline coin may flip under float noise: stop here
        for name in ("epoch", "rejected", "attempts", "accepted"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
        for name in ("tau", "epsilon", "sigma_y"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)), rtol=1e-6,
                                       err_msg=name)
        for name in ("x", "samples", "last_decoded"):
            np.testing.assert_allclose(getattr(state, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       atol=1e-4, rtol=1e-4, err_msg=name)
        compared += 1
    assert compared == 3


def _quadratic(target, weight):
    """A cheap smooth stand-in for the decode + operator loss."""
    jt, jw = jnp.asarray(target), jnp.asarray(weight)
    tt, tw = torch.from_numpy(target), torch.from_numpy(weight)

    def jloss(x):  # one chain
        return jnp.sum(jw * (x - jt) ** 2), jnp.tanh(x)

    def loss(x):  # a batch of chains
        return (tw * (x - tt) ** 2).reshape(x.shape[0], -1).sum(1), torch.tanh(x)

    return jloss, loss


def test_run_to_completion_matches_jax_engine():
    """Whole runs with replayed draws: annealing, the (0.1, 0.01) switch,
    the 0.95 backoff, the sample buffer, finished chains frozen while others
    go on, and chains stopped by max_attempts."""
    shape = (4, 4, 1)
    rng = np.random.default_rng(0)
    target = rng.uniform(-1, 1, shape).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    jloss, loss = _quadratic(target, weight)
    cfg = dict(sigma_0=0.3, tau=1.2, epsilon=0.6, epochs=3, sampling=2, max_attempts=10)
    jcfg, tcfg = jeng.HMCConfig(**cfg), engine.HMCConfig(**cfg)
    n = 6
    key = jax.random.PRNGKey(7)
    trails = {"jax": [], "port": []}

    def recorder(name):
        def record(states, rnd):
            trails[name].append(np.stack([np.asarray(states.epoch, np.float32),
                                          np.asarray(states.tau), np.asarray(states.epsilon),
                                          np.asarray(states.sigma_y)]))
        return record

    jout = jeng.run_hmc_observed(jloss, jcfg, jeng.init_chains(key, jcfg, n, shape),
                                 callback=recorder("jax"))
    x0, p0, u = replay_draws(key, n, shape, cfg["max_attempts"])
    state = engine.init_chains(tcfg, n, shape, device="cpu", x=torch.from_numpy(x0))
    draws = ((torch.from_numpy(p0[a]), torch.from_numpy(u[a])) for a in range(len(u)))
    out = engine.run_hmc(loss, tcfg, state, draws=draws, callback=recorder("port"))

    np.testing.assert_allclose(np.stack(trails["port"]), np.stack(trails["jax"]), rtol=1e-6)
    for name in ("epoch", "rejected", "attempts", "accepted"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(jout, name)), err_msg=name)
    for name in ("tau", "epsilon", "sigma_y", "last_loss"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-5, err_msg=name)
    for name in ("x", "samples", "last_decoded"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the run covers every branch it is meant to exercise
    epoch, tau = np.stack(trails["port"])[:, 0], np.stack(trails["port"])[:, 1]
    assert (out.epoch.numpy() == tcfg.total_epochs).any()  # some chains finished,
    assert (out.attempts.numpy() == tcfg.max_attempts).any()  # some ran out of attempts
    assert (tau[epoch < tcfg.epochs] < np.float32(tcfg.tau)).any()  # backoff while annealing
    assert np.isclose(tau[epoch > tcfg.epochs], tcfg.post_tau).any()  # the switch
    assert (out.samples.abs().sum(dim=(2, 3, 4)) > 0).any()  # samples were written


def test_sigma_y_anneal_matches_jax():
    jcfg, tcfg = jeng.HMCConfig(sigma_0=0.1, epochs=60), engine.HMCConfig(sigma_0=0.1, epochs=60)
    epochs = np.arange(0, 80, dtype=np.int32)
    np.testing.assert_allclose(engine._sigma_y(tcfg, torch.from_numpy(epochs)).numpy(),
                               np.asarray(jeng._sigma_y(jcfg, jnp.asarray(epochs))), rtol=1e-6)
