"""One rank of the port's multi-process tests (tests/test_torch_sharding.py,
tests/test_torch_multihost.py), and the problems they shard.

    python tests/_torch_mh_worker.py cli <nshmc_tpu_torch.cli arguments>
    python tests/_torch_mh_worker.py shard OUT_DIR [DRAWS.npz]

The parent sets the NSHMC_DIST / NSHMC_COORDINATOR / NSHMC_NUM_PROCESSES /
NSHMC_PROCESS_ID contract. `cli` runs the CLI; `shard` runs every problem of
PROBLEMS through the chain-sharded runners on the CPU, and the JAX draws'
replay where DRAWS.npz is given, and saves this rank's gathered end states
to OUT_DIR/rank{i}.pt. The parent builds the same problems (same seeds) for
the unsharded references. Imports torch and the port only.
"""
import contextlib
import os
import sys

import numpy as np
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

from nshmc_tpu_torch.hmc import engine, latent  # noqa: E402
from nshmc_tpu_torch.parallel import chains  # noqa: E402

SHAPE = (4, 4, 1)


def toy_builder(a, operator, y0):
    """decode = identity, H = diag(a): ||y0 - a x||^2 per chain (the toy
    loss of tests/test_sharding.py); `operator` is unused."""

    def loss(x):
        return torch.sum((y0 - a * x.reshape(x.shape[0], -1)) ** 2, dim=1), x

    return loss


def toy(seed, n_chains, **cfg):
    """A toy pixel problem: (cfg, builder, model, operator, y0, state, run
    seed); x_T from the run's generator."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    y0 = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    hcfg = engine.HMCConfig(**cfg)
    gen = torch.Generator().manual_seed(seed)
    state = engine.init_chains(hcfg, n_chains, SHAPE, "cpu", generator=gen)
    return hcfg, toy_builder, a, None, y0, state, seed + 100


def toy_latent(seed, n_chains):
    """The latent sampler on the toy loss (tests/test_latent_drivers.py:86)."""
    _, builder, a, _, y0, _, run_seed = toy(seed, 1)
    lcfg = latent.LatentHMCConfig(sigma_0=0.3, sigma_y0=1.0, tau=0.4, epsilon=0.1, epochs=4,
                                  sampling=2, keep_samples=2)
    state = latent.init_latent_chains(lcfg, n_chains, SHAPE, "cpu",
                                      generator=torch.Generator().manual_seed(seed))
    return lcfg, builder, a, None, y0, state, run_seed


def phase_retrieval_64():
    """64 chains of phase retrieval through the DDIM decode of a tiny U-Net
    (tests/test_sharding.py's BASELINE config 4 shape, with the ladder cut
    from 3 steps to 1 to keep it to seconds), f32, random weights from seed
    0."""
    from nshmc_tpu_torch.models.unet import UNetConfig, UNetModel
    from nshmc_tpu_torch.operators import PhaseRetrieval
    from nshmc_tpu_torch.sampling.ddim import make_decoder
    from nshmc_tpu_torch.schedules import DDIMSequence, DiffusionSchedule

    d = 16
    torch.manual_seed(0)
    model = UNetModel(UNetConfig(image_size=d, model_channels=32, out_channels=6,
                                 num_res_blocks=1, attention_ds=(2,), channel_mult=(1, 2),
                                 num_heads=2, num_head_channels=16)).eval()
    decode = make_decoder(model, DiffusionSchedule.create(num_timesteps=100, device="cpu"),
                          DDIMSequence.create(100, 1))
    op = PhaseRetrieval.create(3, d, oversample=2.0, device="cpu")
    rng = np.random.default_rng(0)
    x_orig = torch.from_numpy(rng.uniform(-1, 1, (1, d, d, 3)).astype(np.float32))
    y0 = op.H_img(x_orig)[0]
    hcfg = engine.HMCConfig(sigma_0=0.2, tau=0.1, epsilon=0.05, epochs=1, sampling=1,
                            max_attempts=8)
    state = engine.init_chains(hcfg, 64, (d, d, 3), "cpu",
                               generator=torch.Generator().manual_seed(2))
    return hcfg, engine.make_pixel_loss_fn, decode, op, y0, state, 3


# name -> (problem, whether it is latent)
PROBLEMS = {
    "toy8": (lambda: toy(0, 8, sigma_0=0.3, tau=0.5, epsilon=0.05, epochs=4, sampling=3,
                         max_attempts=200), False),
    # large eps: frequent rejections, so chains (and ranks) finish at 4-6 attempts and 3
    # chains run out of attempts unfinished
    "toy16": (lambda: toy(1, 16, sigma_0=0.3, tau=1.0, epsilon=0.9, epochs=2, sampling=1,
                          max_attempts=6), False),
    "latent8": (lambda: toy_latent(2, 8), True),
    "phase_retrieval64": (phase_retrieval_64, False),
}
# the JAX draws' replay: the toy8 loss and config, 8 chains, at most JAX_ATTEMPTS attempts
JAX_ATTEMPTS = 40
JAX_CFG = dict(sigma_0=0.3, tau=0.5, epsilon=0.05, epochs=4, sampling=3,
               max_attempts=JAX_ATTEMPTS)


def solve(name, mesh=None):
    """Problem `name` run unsharded (mesh None) or through the sharded runner."""
    problem, is_latent = PROBLEMS[name]
    cfg, builder, model, op, y0, state, seed = problem()
    gen = torch.Generator().manual_seed(seed)
    if mesh is None:
        run = latent.run_latent_hmc if is_latent else engine.run_hmc
        return run(builder(model, op, y0), cfg, state, gen)
    make = chains.make_sharded_latent_hmc if is_latent else chains.make_sharded_hmc
    return make(cfg, mesh, builder)(model, op, y0, state, gen)


def replayed(draws_path, mesh):
    """The toy8 problem from JAX's x_T with JAX's per-attempt draws (saved
    by the parent, one (p0, u) of all chains a round), sharded over `mesh`."""
    f = np.load(draws_path)
    _, builder, a, _, y0, _, _ = toy(0, 1)
    cfg = engine.HMCConfig(**JAX_CFG)
    state = engine.init_chains(cfg, 8, SHAPE, "cpu", x=torch.from_numpy(f["x"]))
    rounds = [(torch.from_numpy(p), torch.from_numpy(u)) for p, u in zip(f["p0"], f["u"])]
    draws = rounds + [rounds[-1]] * cfg.max_attempts
    return chains.make_sharded_hmc(cfg, mesh, builder)(a, None, y0, state, draws=draws)


def fields(state):
    return {k: v.clone() for k, v in vars(state).items()}


@contextlib.contextmanager
def one_thread():
    """The ranks' thread count, for a reference run in the parent."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def launch(args, nproc, timeout=120):
    """Run this script with `args` as `nproc` ranks of one gloo group on
    localhost (one thread each, multihost.launch_local); return their
    outputs. Raises if a rank fails or does not finish cleanly, or where
    the ranks outlast `timeout` seconds together (a hung rendezvous fails
    the caller, it does not hang it)."""
    from nshmc_tpu_torch.parallel import multihost as mh

    outs = mh.launch_local([os.path.abspath(__file__), *args], nproc, timeout, cwd=REPO,
                           env={"OMP_NUM_THREADS": "1"})
    for rank, out in enumerate(outs):
        if f"MH_WORKER_DONE rank={rank}" not in out:
            raise RuntimeError(f"rank {rank} of {nproc} did not finish:\n{out}")
    return outs


def main(argv):
    from nshmc_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    if argv[0] == "cli":
        from nshmc_tpu_torch.cli import main as cli_main

        cli_main(argv[1:])
    else:
        out_dir, *draws = argv[1:]
        mh.maybe_initialize()
        mesh = chains.chain_mesh(mh.process_count(), "cpu")
        results = {name: fields(solve(name, mesh)) for name in PROBLEMS}
        if draws:
            results["jax_replay"] = fields(replayed(draws[0], mesh))
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
        mh.shutdown()
    # one line the parent greps to confirm this rank finished cleanly
    print(f"MH_WORKER_DONE rank={os.environ['NSHMC_PROCESS_ID']}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
