"""The latent engine's driver (nshmc_tpu_torch.hmc.latent.run_latent_hmc) as
the JAX package's run_latent_hmc_observed: a whole run against it with the
JAX draws replayed (integers exact, float32 state rtol 1e-5), and, as
tests/test_latent_drivers.py:52-84 checks them, snapshot and resume and
chain waves, held bit for bit on the CPU against an uninterrupted, unchunked
run of the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.hmc import latent as jlat
from nshmc_tpu_torch.hmc import latent
from _torch_hmc_draws import chain_draws, replay_draws

torch.set_num_threads(2)

SHAPE = (4, 4, 1)
CFG = dict(sigma_0=0.3, sigma_y0=1.0, tau=0.4, epsilon=0.1, epochs=4, sampling=2,
           keep_samples=2)
INTS = ("attempt", "accepted", "rejected", "n_kept")
FLOATS = ("z", "tau", "epsilon", "sigma_y", "samples", "last_z0_accept", "last_loss",
          "last_log_ratio")


def _toy(seed):
    """A linear stand-in for the DDIM ladder and the decoder, as
    tests/test_latent_drivers.py's."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    y0 = rng.standard_normal(16).astype(np.float32)
    ta, ty = torch.from_numpy(a), torch.from_numpy(y0)

    def loss(z):
        return torch.sum((ty - ta * z.reshape(z.shape[0], -1)) ** 2, dim=1), z

    def jloss(z):
        return jnp.sum((jnp.asarray(y0) - jnp.asarray(a) * z.reshape(-1)) ** 2), z

    return loss, jloss


def _fresh(n, seed):
    cfg = latent.LatentHMCConfig(**CFG)
    z = torch.randn((n,) + SHAPE, generator=torch.Generator().manual_seed(seed))
    return cfg, latent.init_latent_chains(cfg, n, SHAPE, device="cpu", z=z)


def _assert_equal(a, b):
    for name in INTS + FLOATS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_run_matches_jax_observed_driver():
    loss, jloss = _toy(0)
    n = 3
    key = jax.random.PRNGKey(0)
    jcfg, tcfg = jlat.LatentHMCConfig(**CFG), latent.LatentHMCConfig(**CFG)
    rounds = []
    jout = jlat.run_latent_hmc_observed(jloss, jcfg, jlat.init_latent_chains(key, jcfg, n, SHAPE))
    z0, p0, u = replay_draws(key, n, SHAPE, tcfg.total_attempts)
    state = latent.init_latent_chains(tcfg, n, SHAPE, device="cpu", z=torch.from_numpy(z0))
    out = latent.run_latent_hmc(loss, tcfg, state, draws=chain_draws(p0, u),
                                callback=lambda s, r: rounds.append(r))
    assert rounds == list(range(tcfg.total_attempts))
    for name in INTS:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                      err_msg=name)
    for name in FLOATS:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert (out.accepted.numpy() > 0).all() and (out.n_kept.numpy() > 0).any()


@pytest.mark.parametrize("apr", [1, 2])
def test_checkpoint_resume_equals_uninterrupted(tmp_path, apr):
    """Snapshot every round, stop after 3 attempts, resume: the same end
    state and the same generator draws as an uninterrupted run."""
    loss, _ = _toy(1)
    tcfg, state = _fresh(2, 1)
    full = latent.run_latent_hmc(loss, tcfg, state, torch.Generator().manual_seed(3),
                                 attempts_per_round=apr)

    class Stop(Exception):
        pass

    def bail(s, rnd):
        if rnd >= 2:
            raise Stop

    ck = str(tmp_path / "ck")
    with pytest.raises(Stop):
        latent.run_latent_hmc(loss, tcfg, state, torch.Generator().manual_seed(3), callback=bail,
                              checkpoint_dir=ck, checkpoint_every=1, attempts_per_round=apr)
    rounds = []
    resumed = latent.run_latent_hmc(loss, tcfg, state, torch.Generator().manual_seed(3),
                                    callback=lambda s, r: rounds.append(r), checkpoint_dir=ck,
                                    checkpoint_every=1, attempts_per_round=apr)
    _assert_equal(resumed, full)
    # the last snapshot holds 2 attempts (the round that raised saved none):
    # the resumed run's first round ends at attempt 2 + apr
    assert rounds[0] == 2 + apr - 1


def test_chain_waves_equal_one_batch():
    loss, _ = _toy(2)
    tcfg, state = _fresh(6, 2)
    ref = latent.run_latent_hmc(loss, tcfg, state, torch.Generator().manual_seed(4))
    sizes = []
    out = latent.run_latent_hmc(lambda z: (sizes.append(z.shape[0]), loss(z))[1], tcfg, state,
                                torch.Generator().manual_seed(4), chain_chunk=2)
    _assert_equal(out, ref)
    assert set(sizes) == {2}
