"""The pixel engine's drivers (nshmc_tpu_torch/hmc/engine.py): snapshot and
resume, the snapshot cadence, chain waves, rounds of several attempts,
images x chains (`run_hmc_multi`) and `reset_rejected_after_backoff`,
against an uninterrupted or unchunked run of the port and against the JAX
package's drivers with its draws replayed. Resume and waves are held bit
for bit on the CPU; against JAX, integers exact and float32 state rtol
1e-5 (the loss is a few float32 operations apart in the two)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu.hmc import engine as jeng
from nshmc_tpu_torch.hmc import engine
from nshmc_tpu_torch.utils import checkpointing
from _torch_hmc_draws import chain_draws, replay_draws

torch.set_num_threads(2)

SHAPE = (4, 4, 1)
DIM = 16
INTS = ("epoch", "rejected", "attempts", "accepted")
FLOATS = ("x", "tau", "epsilon", "sigma_y", "samples", "last_decoded", "last_loss")


def _linear_gaussian(a):
    """decode = identity, H = diag(a): ||y - a x||^2 per chain, as
    tests/test_hmc.py's loss; y is one row or one row per chain."""
    ta = torch.from_numpy(a)

    def builder(y):
        ty = torch.as_tensor(y)
        ty = ty[None] if ty.dim() == 1 else ty

        def loss(x):
            return torch.sum((ty - ta * x.reshape(x.shape[0], -1)) ** 2, dim=1), x
        return loss

    def jbuilder(y):
        ja, jy = jnp.asarray(a), jnp.asarray(y)

        def jloss(x):
            return jnp.sum((jy - ja * x.reshape(-1)) ** 2), x
        return jloss

    return builder, jbuilder


def _problem(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.5, DIM).astype(np.float32)
    y = rng.standard_normal(DIM).astype(np.float32)
    builder, jbuilder = _linear_gaussian(a)
    return builder(y), jbuilder(y)


# large eps: frequent rejections, so chains finish at different attempt counts
CFG = dict(sigma_0=0.3, tau=1.0, epsilon=0.9, epochs=2, sampling=1, max_attempts=60)


def _fresh(n, seed=7, cfg=CFG):
    tcfg = engine.HMCConfig(**cfg)
    x = torch.randn((n,) + SHAPE, generator=torch.Generator().manual_seed(seed + 100))
    return tcfg, engine.init_chains(tcfg, n, SHAPE, device="cpu", x=x)


def _assert_equal(a, b, exact=True):
    for name in INTS + FLOATS:
        x, y = getattr(a, name), getattr(b, name)
        if exact:
            assert torch.equal(x, y), name
        else:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def _stop_at(rnd_stop):
    class Stop(Exception):
        pass

    def callback(state, rnd):
        if rnd >= rnd_stop:
            raise Stop
    return Stop, callback


@pytest.mark.parametrize("draws", ["generator", "replayed"])
def test_resume_equals_uninterrupted_run(tmp_path, draws):
    """A run stopped mid-way and resumed from its snapshot ends bit for bit
    where an uninterrupted run ends, with chains that finish at different
    attempt counts (tests/test_hmc.py:239-285): the snapshot carries the
    generator's state, and replayed draws go on from each chain's own
    attempt count."""
    loss, _ = _problem(3)
    tcfg, state0 = _fresh(8)
    key = jax.random.PRNGKey(7)
    _, p0, u = replay_draws(key, 8, SHAPE, CFG["max_attempts"])

    def run(**kw):
        if draws == "generator":
            return engine.run_hmc(loss, tcfg, state0, torch.Generator().manual_seed(5), **kw)
        start = kw.pop("start", None)
        return engine.run_hmc(loss, tcfg, state0, draws=chain_draws(p0, u, start), **kw)

    ref = run()
    assert int(ref.attempts.max()) > int(ref.attempts.min()), "needs heterogeneous chains"
    ck = str(tmp_path / "ck")
    Stop, interrupt = _stop_at(int(ref.attempts.max()) // 2)
    with pytest.raises(Stop):
        run(callback=interrupt, checkpoint_dir=ck, checkpoint_every=1)
    kw = {}
    if draws == "replayed":
        kw["start"] = checkpointing.load_chain_state(ck, state0).attempts.numpy()
    resumed = run(checkpoint_dir=ck, **kw)
    _assert_equal(resumed, ref)


def test_snapshot_round_trip_keeps_types_and_generator(tmp_path):
    tcfg, state = _fresh(3)
    g = torch.Generator().manual_seed(9)
    torch.randn(5, generator=g)
    checkpointing.save_chain_state(str(tmp_path), state, generators=(g,))
    after = torch.randn(4, generator=g)
    fresh = torch.Generator().manual_seed(1)
    back = checkpointing.load_chain_state(str(tmp_path), state, generators=(fresh,))
    assert type(back) is engine.ChainState
    for name, v in state.fields().items():
        assert torch.equal(getattr(back, name), v) and getattr(back, name).dtype == v.dtype
    assert torch.equal(torch.randn(4, generator=fresh), after)
    assert checkpointing.load_chain_state(str(tmp_path / "none"), state) is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0.pt"]  # no temporary left


def test_snapshot_cadence_is_every_checkpoint_every_attempts(tmp_path, monkeypatch):
    """attempts_per_round 3, checkpoint_every 10: snapshots at attempts 12,
    24, ... as the JAX driver counts them (tests/test_hmc.py:338-366)."""
    saves = []
    monkeypatch.setattr(checkpointing, "save_chain_state",
                        lambda d, s, step=0, generators=(): saves.append(int(s.attempts.max())))
    monkeypatch.setattr(checkpointing, "load_chain_state",
                        lambda d, s, step=0, generators=(): None)
    loss, _ = _problem(3)
    tcfg, state = _fresh(2, cfg=dict(CFG, epochs=8, sampling=4))
    engine.run_hmc(loss, tcfg, state, torch.Generator().manual_seed(2),
                   checkpoint_dir=str(tmp_path), checkpoint_every=10, attempts_per_round=3)
    assert len(saves) >= 2 and saves[0] == 12 and saves[1] == 24, saves


@pytest.mark.parametrize("apr", [1, 3])
def test_chain_waves_equal_one_batch(apr):
    """16 chains in waves of 4 give the unchunked run's states bit for bit,
    with one or three attempts a round (tests/test_hmc.py:369-390)."""
    loss, _ = _problem(11)
    tcfg, state = _fresh(16, seed=4, cfg=dict(CFG, max_attempts=40))
    ref = engine.run_hmc(loss, tcfg, state, torch.Generator().manual_seed(4))
    waves = []

    def counting(x):
        waves.append(x.shape[0])
        return loss(x)

    out = engine.run_hmc(counting, tcfg, state, torch.Generator().manual_seed(4),
                         chain_chunk=4, attempts_per_round=apr)
    _assert_equal(out, ref)
    assert set(waves) == {4}
    with pytest.raises(ValueError, match="not divisible"):
        engine.run_hmc(loss, tcfg, state, chain_chunk=5)


def test_attempts_per_round_keep_max_attempts():
    """A chain that never accepts stops at max_attempts exactly, also when
    attempts_per_round does not divide it (tests/test_hmc.py:322-335)."""
    tcfg, state = _fresh(2, cfg=dict(CFG, tau=0.2, epsilon=0.1, epochs=1, max_attempts=5))
    never = lambda x: (float("inf") * (x**2).reshape(x.shape[0], -1).sum(1), x)  # NaN ratio
    out = engine.run_hmc(never, tcfg, state, torch.Generator().manual_seed(0),
                         attempts_per_round=3)
    assert out.attempts.tolist() == [5, 5] and out.accepted.tolist() == [0, 0]


def test_run_hmc_multi_matches_jax_and_each_image_alone():
    """2 images x 3 chains as one batch: the JAX package's run_hmc_multi with
    its draws replayed, and each image's chains against that image run
    alone with the same generator."""
    rng = np.random.default_rng(21)
    a = rng.uniform(0.5, 1.5, DIM).astype(np.float32)
    y0s = rng.standard_normal((2, DIM)).astype(np.float32)
    builder, jbuilder = _linear_gaussian(a)
    cfg = dict(CFG, max_attempts=30)
    tcfg, jcfg = engine.HMCConfig(**cfg), jeng.HMCConfig(**cfg)
    n = 3
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jstates = jax.vmap(lambda k: jeng.init_chains(k, jcfg, n, SHAPE))(keys)
    jout = jax.jit(lambda s, y: jeng.run_hmc_multi(jbuilder, jcfg, s, y))(jstates,
                                                                          jnp.asarray(y0s))
    replays = [replay_draws(k, n, SHAPE, cfg["max_attempts"]) for k in keys]
    x0 = np.concatenate([r[0] for r in replays])
    p0 = np.concatenate([r[1] for r in replays], axis=1)
    u = np.concatenate([r[2] for r in replays], axis=1)
    state = engine.init_chains(tcfg, 2 * n, SHAPE, device="cpu", x=torch.from_numpy(x0))
    out = engine.run_hmc_multi(builder, tcfg, state, torch.from_numpy(y0s),
                               draws=chain_draws(p0, u))
    flat = jax.tree.map(lambda v: np.asarray(v).reshape((2 * n,) + v.shape[2:]), jout)
    _assert_equal(out, flat, exact=False)
    assert len(set(out.attempts.tolist())) > 1

    gens = [torch.Generator().manual_seed(s) for s in (31, 32)]
    multi = engine.run_hmc_multi(builder, tcfg, state, torch.from_numpy(y0s), gens)
    for i, seed in enumerate((31, 32)):
        alone = engine.run_hmc(builder(y0s[i]), tcfg, engine._chains(state, i * n, (i + 1) * n),
                               torch.Generator().manual_seed(seed))
        _assert_equal(engine._chains(multi, i * n, (i + 1) * n), alone)


def test_reset_rejected_after_backoff_matches_jax():
    """With the reset on, the rejection count goes back to 0 at each
    backoff; whole runs match the JAX engine with its draws replayed."""
    loss, jloss = _problem(5)
    cfg = dict(CFG, reset_rejected_after_backoff=True, max_attempts=25)
    tcfg, jcfg = engine.HMCConfig(**cfg), jeng.HMCConfig(**cfg)
    n = 6
    key = jax.random.PRNGKey(17)
    jout = jeng.run_hmc_observed(jloss, jcfg, jeng.init_chains(key, jcfg, n, SHAPE))
    x0, p0, u = replay_draws(key, n, SHAPE, cfg["max_attempts"])
    state = engine.init_chains(tcfg, n, SHAPE, device="cpu", x=torch.from_numpy(x0))
    trail = []
    out = engine.run_hmc(loss, tcfg, state, draws=chain_draws(p0, u),
                         callback=lambda s, r: trail.append(s.rejected.clone()))
    _assert_equal(out, jout, exact=False)
    rejected = torch.stack(trail)
    assert int(rejected.max()) <= 1  # reset at every second rejection
    plain = []
    engine.run_hmc(loss, dataclasses.replace(tcfg, reset_rejected_after_backoff=False), state,
                   draws=chain_draws(p0, u), callback=lambda s, r: plain.append(s.rejected.clone()))
    assert int(torch.stack(plain).max()) >= 2  # the run reaches backoffs at all
