"""Chain parallelism over processes (port of nshmc_tpu/parallel/chains.py).

The JAX package `shard_map`s its HMC driver over a 1-D ('chain',) device
mesh; the body holds no collective. Here a mesh is one process per device
(`ChainMesh`): each rank runs the unchanged driver (`run_hmc`,
`run_latent_hmc`) on its contiguous slice of the chains on its own device,
and the chain states are gathered on the host over the process group
afterwards, so every rank holds the whole result, as JAX's global array.

Randomness: every rank draws each attempt's momenta and uniforms for ALL
chains from its copy of the run's generator (the scheme `engine.
attempt_in_waves` uses for chain waves) and keeps its own rows, so a
sharded run takes the unsharded run's draws and, on the CPU, equals it bit
for bit. A rank whose chains are all done stops drawing; the draws it skips
are ones the unsharded run does not use for those chains.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..hmc.engine import ChainState, HMCConfig, _chains, _replace, draw_attempt, run_hmc
from . import multihost as mh

LAUNCH_HINT = ("launch one process per device with the NSHMC_* contract "
               "(nshmc_tpu_torch/parallel/multihost.py), e.g. `NSHMC_DIST=1 torchrun "
               "--nproc_per_node {n} -m nshmc_tpu_torch.cli --mesh {n} ...`, or set "
               "NSHMC_DIST=1, NSHMC_COORDINATOR=host:port, NSHMC_NUM_PROCESSES={n} and "
               "NSHMC_PROCESS_ID=i in each of {n} processes")


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """A 1-D chain mesh: `size` processes, this process's `rank` and
    `device`, and the process `group` the states are gathered over (None:
    no process group, a mesh of one)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup]


def chain_mesh(n: int, device="cuda") -> ChainMesh:
    """The mesh of every process (the counterpart of both `chain_mesh` and
    `global_chain_mesh`: one device a process). `n` must be the process
    count."""
    count = mh.process_count()
    if n != count:
        raise ValueError(f"a chain mesh of {n} needs {n} processes, one a device, and this "
                         f"run has {count}: " + LAUNCH_HINT.format(n=n))
    return ChainMesh(count, mh.process_index(), mh.rank_device(device),
                     dist.group.WORLD if count > 1 else None)


def _rows(mesh: ChainMesh, n_chains: int) -> Tuple[int, int]:
    if n_chains % mesh.size != 0:
        raise ValueError(f"{n_chains} chains do not split over a mesh of {mesh.size}")
    per = n_chains // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def fetch_local_shards(mesh: ChainMesh, state):
    """This rank's contiguous rows of a global chain state (any dataclass of
    tensors with the chain axis first)."""
    field = dataclasses.fields(state)[0].name
    return _chains(state, *_rows(mesh, getattr(state, field).shape[0]))


def make_global_chain_states(mesh: ChainMesh, state):
    """Every rank's rows of a chain state gathered in rank order over the
    mesh's group (as host tensors, then back on each field's device): the
    global state, on every rank."""
    if mesh.size == 1:
        return state

    def gather(name, v):
        parts = [torch.empty_like(v, device="cpu") for _ in range(mesh.size)]
        dist.all_gather(parts, v.detach().cpu().contiguous(), group=mesh.group)
        return torch.cat(parts).to(v.device)

    return _replace(state, gather)


def _local_draws(global_draws: Iterable, lo: int, hi: int) -> Iterator:
    for p0, u in global_draws:
        yield p0[lo:hi], u[lo:hi]


def _generated(generator: Optional[torch.Generator], like: torch.Tensor) -> Iterator:
    while True:
        yield draw_attempt(generator, like)


def _sharded(run: Callable, cfg, mesh: ChainMesh, loss_fn_builder: Callable, field: str):
    def runner(model, operator, y0, state, generator: Optional[torch.Generator] = None,
               draws: Optional[Iterable] = None):
        loss_fn = loss_fn_builder(model, operator, y0)
        glob = getattr(state, field)
        lo, hi = _rows(mesh, glob.shape[0])
        draws = _generated(generator, glob) if draws is None else draws
        out = run(loss_fn, cfg, fetch_local_shards(mesh, state),
                  draws=_local_draws(draws, lo, hi))
        return make_global_chain_states(mesh, out)

    return runner


def make_sharded_hmc(cfg: HMCConfig, mesh: ChainMesh, loss_fn_builder: Callable):
    """A chain-sharded `run_hmc`: runner(model, operator, y0, global state,
    generator, draws=None) -> the global end state on every rank.
    loss_fn_builder(model, operator, y0) -> the per-chain loss_fn (e.g.
    `make_pixel_loss_fn` with the decoder as the model). Every rank passes
    the same global state and a generator seeded alike; `draws` optionally
    yields each attempt's (p0, u) of ALL chains instead (a replay). The
    chain count must be a multiple of the mesh size."""
    return _sharded(run_hmc, cfg, mesh, loss_fn_builder, "x")


def make_sharded_latent_hmc(cfg, mesh: ChainMesh, loss_fn_builder: Callable):
    """The latent analogue of `make_sharded_hmc` (`run_latent_hmc`, states
    sharded on their leading axis); loss_fn_builder(model, operator, y0) ->
    the per-chain latent loss_fn (see hmc.latent.make_latent_loss_fn)."""
    from ..hmc.latent import run_latent_hmc

    return _sharded(run_latent_hmc, cfg, mesh, loss_fn_builder, "z")


def acceptance_stats(states: ChainState, cfg: HMCConfig) -> dict:
    """Acceptance statistics over all chains (host side). `chains_done`
    counts the chains that reached cfg.total_epochs (the JAX package's
    counts every chain: its test is epoch >= 0)."""
    acc = states.accepted.cpu().numpy().astype(np.float64)
    att = states.attempts.cpu().numpy().astype(np.float64)
    return {
        "accept_rate": float(acc.sum() / max(att.sum(), 1.0)),
        "mean_attempts": float(att.mean()),
        "chains_done": int((states.epoch >= cfg.total_epochs).sum()),
    }
