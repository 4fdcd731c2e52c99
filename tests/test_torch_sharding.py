"""Chain sharding over processes (nshmc_tpu_torch/parallel/chains.py), as
tests/test_sharding.py holds it for the JAX package: a gloo group of 2 and
of 4 CPU processes (tests/_torch_mh_worker.py, spawned here) runs each
problem through the sharded runners, and every rank's gathered end state
equals the unsharded run's bit for bit: the toy loss at 8 and 16 chains
(the 16 with rejections, chains and ranks finishing at different attempts
and some chains unfinished), the latent runner, and 64 phase-retrieval
chains through a tiny U-Net. `acceptance_stats` counts finished chains
only. The port's sharded runner, fed JAX's draws, matches JAX's
`make_sharded_hmc` on the conftest's 8 virtual devices: integers exact,
float32 state rtol 1e-5 (tests/test_torch_hmc.py's bar)."""
import itertools
import types

import jax
import numpy as np
import pytest
import torch

from nshmc_tpu.hmc import engine as jeng
from nshmc_tpu.parallel import chains as jchains
from nshmc_tpu_torch.parallel import chains
import _torch_mh_worker as worker
from _torch_hmc_draws import chain_draws, replay_draws

GROUPS = (2, 4)
INTS = ("epoch", "rejected", "attempts", "accepted")
FLOATS = ("x", "tau", "epsilon", "sigma_y", "samples", "last_decoded", "last_loss")


@pytest.fixture(scope="module")
def jax_draws(tmp_path_factory):
    """JAX's x_T and per-attempt draws for the toy8 problem's 8 chains, one
    (p0, u) of all chains a round as chain_draws yields them."""
    x, p0, u = replay_draws(jax.random.PRNGKey(0), 8, worker.SHAPE, worker.JAX_ATTEMPTS)
    rounds = list(itertools.islice(chain_draws(p0, u), worker.JAX_ATTEMPTS))
    path = tmp_path_factory.mktemp("draws") / "draws.npz"
    np.savez(path, x=x, p0=np.stack([p.numpy() for p, _ in rounds]),
             u=np.stack([v.numpy() for _, v in rounds]))
    return str(path)


@pytest.fixture(scope="module", params=GROUPS, ids=[f"{n}proc" for n in GROUPS])
def sharded(request, tmp_path_factory, jax_draws):
    """Every rank's gathered end states of a launch of `param` ranks."""
    out = tmp_path_factory.mktemp(f"shard{request.param}")
    worker.launch(["shard", str(out), jax_draws], request.param)
    return [torch.load(out / f"rank{r}.pt") for r in range(request.param)]


@pytest.fixture(scope="module")
def references():
    with worker.one_thread():
        return {name: vars(worker.solve(name)) for name in worker.PROBLEMS}


@pytest.mark.parametrize("name", sorted(worker.PROBLEMS))
def test_sharded_equals_unsharded_bit_for_bit(sharded, references, name):
    ref = references[name]
    for rank, results in enumerate(sharded):
        got = results[name]
        assert got.keys() == ref.keys()
        for field, v in ref.items():
            assert torch.equal(got[field], v), (rank, field)


def test_toy16_ranks_finish_apart(references):
    """The 16-chain problem covers a rank stopping while others go on, and
    chains that run out of attempts."""
    out = references["toy16"]
    att = out["attempts"].reshape(4, 4).amax(dim=1)
    assert len(set(att.tolist())) > 1
    assert (out["epoch"] < 4).any() and (out["epoch"] == 4).any()


def test_64_chain_phase_retrieval_completes(references):
    cfg = worker.phase_retrieval_64()[0]
    out = references["phase_retrieval64"]
    assert out["attempts"].shape == (64,)
    assert ((out["epoch"] >= cfg.total_epochs) | (out["attempts"] >= cfg.max_attempts)).all()
    assert torch.isfinite(out["x"]).all()


def test_acceptance_stats_counts_finished_chains_only(references):
    cfg = worker.PROBLEMS["toy16"][0]()[0]
    out = worker.solve("toy16")
    stats = chains.acceptance_stats(out, cfg)
    done = int((out.epoch >= cfg.total_epochs).sum())
    assert stats["chains_done"] == done == 13
    acc, att = out.accepted.double(), out.attempts.double()
    assert stats["accept_rate"] == pytest.approx(float(acc.sum() / att.sum()))
    assert 0.0 < stats["accept_rate"] < 1.0
    assert stats["mean_attempts"] == pytest.approx(float(att.mean()))
    # the JAX package's counts every chain (its test is epoch >= 0)
    jstats = jchains.acceptance_stats(types.SimpleNamespace(
        **{k: np.asarray(getattr(out, k)) for k in ("accepted", "attempts", "epoch")}))
    assert jstats["chains_done"] == 16
    assert jstats["accept_rate"] == pytest.approx(stats["accept_rate"])


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's make_sharded_hmc on the 8 virtual devices, one chain each."""
    cfg = jeng.HMCConfig(**worker.JAX_CFG)
    _, _, a, _, y0, _, _ = worker.toy(0, 1)
    mesh = jchains.chain_mesh()
    assert mesh.devices.size == 8

    def builder(params, operator, y):
        def loss(x):
            return jax.numpy.sum((y - params * x.reshape(-1)) ** 2), x
        return loss

    states = jeng.init_chains(jax.random.PRNGKey(0), cfg, 8, worker.SHAPE)
    out = jchains.make_sharded_hmc(cfg, mesh, builder)(
        jax.numpy.asarray(a.numpy()), jax.numpy.zeros(()), jax.numpy.asarray(y0.numpy()), states)
    return {k: np.asarray(getattr(out, k)) for k in INTS + FLOATS}


def test_sharded_runner_matches_jax_make_sharded_hmc(sharded, jax_sharded):
    for rank, results in enumerate(sharded):
        got = results["jax_replay"]
        for name in INTS:
            np.testing.assert_array_equal(got[name].numpy(), jax_sharded[name],
                                          err_msg=f"rank {rank} {name}")
        for name in FLOATS:
            np.testing.assert_allclose(got[name].numpy(), jax_sharded[name], rtol=1e-5,
                                       atol=1e-5, err_msg=f"rank {rank} {name}")
    assert (jax_sharded["epoch"] > 0).all()
