"""The latent slice as a whole: nshmc_tpu_torch's latent loss (3-step latent
DDIM through the tiny latent U-Net, stop-gradient eps-net, VQ decoder,
inpainting) and its z-gradient against jax.value_and_grad of the JAX
package's make_latent_loss_fn, and the batched latent HMC engine against
nshmc_tpu.hmc.latent.latent_hmc_attempt with the momentum and
accept-uniform draws of the JAX key chain replayed into the port. Weights
from numpy at configs/tiny_latent_test.yaml's sizes (test_torch_ldm)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.hmc import latent as jlat
from nshmc_tpu.models.ldm import autoencoder as jae
from nshmc_tpu.operators import build_operator as jax_build_operator
from nshmc_tpu.sampling.ddim import make_decoder as jax_make_decoder
from nshmc_tpu.schedules import DDIMSequence as JaxSeq
from nshmc_tpu.schedules import DiffusionSchedule as JaxSched
from nshmc_tpu_torch.hmc import engine
from nshmc_tpu_torch.hmc import latent
from nshmc_tpu_torch.models.ldm import LatentDiffusion
from nshmc_tpu_torch.operators import build_operator
from nshmc_tpu_torch.sampling.ddim import make_decoder
from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule
from test_torch_hmc import _quadratic, replay_draws
from test_torch_ldm import jax_latent_unet, jax_vq, port_ae, port_unet

torch.set_num_threads(2)

D, ZD, T = 16, 8, 100  # image side, latent side, schedule length (tiny_latent_test.yaml)
Z_SHAPE = (ZD, ZD, 3)
# the fields of the two states, compared after every attempt
INT_FIELDS = ("attempt", "accepted", "rejected", "n_kept")
FLOAT_FIELDS = ("tau", "epsilon", "sigma_y")
ARRAY_FIELDS = ("z", "samples", "last_z0_accept")


def _latent_problem(stop_grad=True, seed=0):
    """The JAX latent loss (one chain) and the port's (a batch of chains):
    y0 = H(x_orig) for a random image, 92% random inpainting."""
    jm_u, uparams, ucfg = jax_latent_unet(seed)
    jm_a, aparams, acfg = jax_vq(seed=seed + 1)

    def jmodel(z, t):
        out = jm_u.apply(uparams, z, t)
        return jax.lax.stop_gradient(out) if stop_grad else out

    jdec_z = jax_make_decoder(jmodel, JaxSched.create("quad", 0.0015, 0.0195, T),
                              JaxSeq.create(T, 3), scan_remat=False)
    jdec_x = lambda z0: jm_a.apply(aparams, z0, method=jae.VQModel.decode)
    jop = jax_build_operator("inpaint_random", 3, D, np.random.default_rng(seed))
    x_orig = np.random.default_rng(seed + 2).uniform(-1, 1, (1, D, D, 3)).astype(np.float32)
    y0 = np.array(jop.H_img(jnp.asarray(x_orig)))[0]
    jloss = jlat.make_latent_loss_fn(jdec_z, jdec_x, jop, jnp.asarray(y0))

    ldm = LatentDiffusion(ucfg, acfg, DiffusionSchedule.create("quad", 0.0015, 0.0195, T,
                                                               device="cpu"))
    ldm.unet.load_state_dict(port_unet(uparams, ucfg).state_dict())
    ldm.first_stage.load_state_dict(port_ae(type(ldm.first_stage), aparams, acfg).state_dict())
    decode_z = make_decoder(ldm.model_fn(stop_gradient=stop_grad), ldm.schedule,
                            DDIMSequence.create(T, 3))
    op = build_operator("inpaint_random", 3, D, np.random.default_rng(seed), device="cpu")
    loss = latent.make_latent_loss_fn(decode_z, ldm.decode_first_stage, op, torch.from_numpy(y0))
    return jloss, loss


@pytest.mark.parametrize("stop_grad", [True, False], ids=["stop_grad", "full_grad"])
def test_latent_loss_and_grad_match_jax(stop_grad):
    """Per-chain loss, the DDIM-decoded z0 and the z-gradient; with the
    eps-net stop-gradded (the default) and differentiated through."""
    jloss, loss = _latent_problem(stop_grad)
    z = np.random.default_rng(5).standard_normal((2,) + Z_SHAPE).astype(np.float32)
    (jl, jz0), jg = jax.vmap(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(z))
    l, z0, g = engine.value_and_grad(loss, torch.from_numpy(z))
    assert l.shape == (2,) and z0.shape == (2,) + Z_SHAPE
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-4)
    np.testing.assert_allclose(z0.numpy(), np.asarray(jz0), atol=2e-4, rtol=1e-3)
    g, jg = g.numpy(), np.asarray(jg)
    # three chained eps-net calls and the VQ decoder: compared as in test_torch_hmc
    assert np.linalg.norm(g - jg) / np.linalg.norm(jg) < 2e-4
    np.testing.assert_allclose(g, jg, rtol=1e-3, atol=2e-3 * np.abs(jg).max())


def test_stop_gradient_changes_the_gradient():
    """The stop-gradient is real: with it the eps-net is a constant, so the
    z-gradient differs from the full one (by far more than the tolerance
    above)."""
    z = torch.from_numpy(np.random.default_rng(6).standard_normal((2,) + Z_SHAPE)
                         .astype(np.float32))
    g_stop = engine.value_and_grad(_latent_problem(True)[1], z)[2]
    g_full = engine.value_and_grad(_latent_problem(False)[1], z)[2]
    assert float((g_stop - g_full).norm() / g_full.norm()) > 1e-2


def _compare(state, jstate, rtol=1e-6, atol=1e-4):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=rtol, err_msg=name)
    for name in ARRAY_FIELDS:
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   atol=atol, rtol=atol, err_msg=name)


def test_latent_attempts_match_jax_engine():
    """Three MH attempts of the latent loss, 3 chains, L = 2, with the JAX
    key chain's draws: the same trajectories, decisions, anneal and sample
    ring. The anneal lasts one attempt; sigma_y is large enough that
    proposals are accepted at this loss scale."""
    jloss, loss = _latent_problem()
    cfg = dict(sigma_0=20.0, sigma_y0=60.0, tau=0.1, epsilon=0.05, epochs=1, sampling=1,
               keep_samples=1)
    jcfg, tcfg = jlat.LatentHMCConfig(**cfg), latent.LatentHMCConfig(**cfg)
    assert tcfg.n_leapfrog == jcfg.n_leapfrog == 2
    key = jax.random.PRNGKey(42)
    jstate = jlat.init_latent_chains(key, jcfg, 3, Z_SHAPE)
    z0, p0, u = replay_draws(key, 3, Z_SHAPE, tcfg.total_attempts)
    np.testing.assert_array_equal(np.asarray(jstate.z), z0)
    state = latent.init_latent_chains(tcfg, 3, Z_SHAPE, device="cpu", z=torch.from_numpy(z0))
    _compare(state, jstate)
    attempt = jax.jit(jax.vmap(lambda s: jlat.latent_hmc_attempt(jloss, jcfg, s)))
    accepted = 0
    for a in range(tcfg.total_attempts):
        jstate = attempt(jstate)
        state = latent.latent_hmc_attempt(loss, tcfg, state, p0=torch.from_numpy(p0[a]),
                                          u=torch.from_numpy(u[a]))
        margin = np.abs(np.log(u[a]) - np.minimum(state.last_log_ratio.numpy(), 0.0))
        assert (margin > 1e-3).all(), margin  # no coin close enough to flip
        np.testing.assert_allclose(state.last_log_ratio.numpy(),
                                   np.asarray(jstate.last_log_ratio), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(state.last_loss.numpy(), np.asarray(jstate.last_loss),
                                   rtol=1e-4)
        _compare(state, jstate)
        accepted = int(state.accepted.sum())
    assert accepted > 0 and int(state.n_kept.sum()) > 0  # accepts, and a kept sample


def test_latent_run_matches_jax_over_the_anneal_and_backoffs():
    """Ten attempts of 6 chains on a cheap smooth loss, every attempt held
    to the JAX engine: the geometric anneal on accept, the post-anneal pin
    of (tau, eps), the x0.9 backoff with its counter reset, the ring of the
    previous accepted z0, and last_loss from inf."""
    rng = np.random.default_rng(0)
    target = rng.uniform(-1, 1, Z_SHAPE).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, Z_SHAPE).astype(np.float32)
    jloss, loss = _quadratic(target, weight)
    cfg = dict(sigma_0=0.3, sigma_y0=1.0, tau=1.2, epsilon=0.6, epochs=4, sampling=3,
               keep_samples=2)
    jcfg, tcfg = jlat.LatentHMCConfig(**cfg), latent.LatentHMCConfig(**cfg)
    n = 6
    key = jax.random.PRNGKey(7)
    jstate = jlat.init_latent_chains(key, jcfg, n, Z_SHAPE)
    z0, p0, u = replay_draws(key, n, Z_SHAPE, tcfg.total_attempts)
    state = latent.init_latent_chains(tcfg, n, Z_SHAPE, device="cpu", z=torch.from_numpy(z0))
    assert np.isinf(state.last_loss.numpy()).all()
    attempt = jax.jit(jax.vmap(lambda s: jlat.latent_hmc_attempt(jloss, jcfg, s)))
    trail = []
    draws = ((torch.from_numpy(p0[a]), torch.from_numpy(u[a])) for a in range(len(u)))

    def step(s, rnd):
        nonlocal jstate
        jstate = attempt(jstate)
        _compare(s, jstate, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s.last_loss.numpy(), np.asarray(jstate.last_loss), rtol=1e-5)
        trail.append((s.tau.numpy().copy(), s.rejected.numpy().copy(),
                      s.accepted.numpy().copy()))

    out = latent.run_latent_hmc(loss, tcfg, state, draws=draws, callback=step)
    assert len(trail) == tcfg.total_attempts and (out.attempt.numpy() == 10).all()
    # the run covers the branches it is meant to exercise
    taus = np.stack([t[0] for t in trail])
    backoffs = (taus[1:] < taus[:-1] - 1e-7) & (np.stack([t[2] for t in trail])[1:]
                                                 == np.stack([t[2] for t in trail])[:-1])
    assert backoffs.sum() >= 2  # x0.9 backoffs on rejection
    assert np.isclose(out.tau.numpy(), tcfg.post_tau).any()  # a post-anneal accept pinned tau
    assert (out.n_kept.numpy() > tcfg.keep_samples).any()  # the ring wrapped
    assert (out.sigma_y.numpy() < tcfg.sigma_y0).any()  # the anneal moved on accept
    assert np.isfinite(out.last_loss.numpy()).any()
