"""HMC adaptation (port of nshmc_tpu/hmc/adaptation.py): dual-averaging
step-size adaptation and diagonal mass-matrix conditioning.

Dual averaging (Hoffman and Gelman's NUTS step-size adapter) drives one
step size, shared by the chains still annealing, toward a target
acceptance. Its recursion runs in float32 tensors, as the JAX package
computes it (Python floats are float64 and would drift from it).

Mass-conditioned HMC (the reference's `hmc_test_conditioning`): the
Welford variance of each trajectory's positions, ranked and scaled to
scores in [-1, 1], gives M = exp(k * scores) after each accepted proposal
past epochs // 3; the anneal has a burn phase at sigma_0 + 0.9 and a cubic
decay, and a chain runs burn + epochs + 4 * sampling accepted epochs. The
chains are the batch axis, as in hmc/engine.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import torch

from .engine import (LossFn, _per_chain, _select, draw_attempt, drive, hmc_attempt,
                     leapfrog_propose, write_samples)


# --- dual averaging ---------------------------------------------------------

@dataclasses.dataclass
class DualAveragingState:
    """float32 scalars (t int32), as nshmc_tpu/hmc/adaptation.py:30-45."""

    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor

    @classmethod
    def create(cls, eps0: float, device="cuda"):
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return cls(log_eps=f32(math.log(eps0)), log_eps_avg=f32(math.log(eps0)),
                   h_sum=f32(0.0), mu=f32(math.log(10.0 * eps0)),
                   t=torch.tensor(0, dtype=torch.int32, device=device))


def dual_averaging_update(state: DualAveragingState, accept_prob: torch.Tensor,
                          target: float = 0.65, gamma: float = 0.05, t0: float = 10.0,
                          kappa: float = 0.75) -> DualAveragingState:
    """One Hoffman-Gelman dual-averaging step toward `target` acceptance
    (nshmc_tpu/hmc/adaptation.py:48-59)."""
    t = state.t + 1
    tf = t.to(torch.float32)
    h_sum = state.h_sum + (target - accept_prob)
    log_eps = state.mu - torch.sqrt(tf) / gamma * h_sum / (tf + t0)
    w = tf ** (-kappa)
    log_eps_avg = w * log_eps + (1 - w) * state.log_eps_avg
    return DualAveragingState(log_eps=log_eps, log_eps_avg=log_eps_avg, h_sum=h_sum,
                              mu=state.mu, t=t)


def run_hmc_dual_averaging(loss_fn: LossFn, cfg, state, target_accept: float = 0.65,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
                           callback=None):
    """Lockstep HMC over the chains with a SHARED dual-averaged step size
    (nshmc_tpu/hmc/adaptation.py:62-136). Before each round the shared eps
    goes to the chains still annealing; after it, the mean acceptance over
    the chains that were running drives one dual-averaging update (none on a
    round where no chain runs); finished chains keep their state. At most
    cfg.max_attempts rounds. `draws` optionally yields one (unit-normal p0,
    u) per round; `callback(state, da, round)` runs after each. Returns
    (state, da)."""
    da = DualAveragingState.create(cfg.epsilon, device=state.x.device)
    draws = iter(draws) if draws is not None else None
    rnd = 0
    while rnd < cfg.max_attempts and bool((state.epoch < cfg.total_epochs).any()):
        in_anneal = state.epoch < cfg.epochs
        state = dataclasses.replace(
            state, epsilon=torch.where(in_anneal, torch.exp(da.log_eps), state.epsilon))
        prev_epoch = state.epoch
        p0, u = next(draws) if draws is not None else draw_attempt(generator, state.x)
        new, _ = hmc_attempt(loss_fn, cfg, state, p0=p0, u=u)
        accepted = (new.epoch > prev_epoch).to(torch.float32)
        running = (prev_epoch < cfg.total_epochs).to(torch.float32)
        n_running = torch.sum(running)
        acc = torch.sum(accepted * running) / torch.clamp(n_running, min=1.0)
        if bool(n_running > 0):
            da = dual_averaging_update(da, acc, target=target_accept)
        state = _select(prev_epoch < cfg.total_epochs, new, state)
        if callback is not None:
            callback(state, da, rnd)
        rnd += 1
    return state, da


# --- mass-conditioned HMC ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConditionedHMCConfig:
    """hmc_test_conditioning hyperparameters (nshmc_tpu/hmc/adaptation.py:141-163)."""

    sigma_0: float = 0.1
    tau: float = 1.0
    epsilon: float = 0.05
    burn: int = 5
    epochs: int = 40
    sampling: int = 10
    anneal_scale: float = 0.9
    anneal_power: float = 3.0
    post_tau: float = 0.1
    post_epsilon: float = 0.01
    backoff: float = 0.95
    mass_k: float = 1.0  # the exponent scale k in exp(k * scores)
    max_attempts: int = 1000

    @property
    def n_leapfrog(self) -> int:
        return max(1, math.floor(self.tau / self.epsilon))

    @property
    def total_epochs(self) -> int:
        return self.burn + self.epochs + 4 * self.sampling


@dataclasses.dataclass
class ConditionedChainState:
    """State of N chains, the chain axis first. x, mass_diag: (N, H, W, C);
    samples: (N, max(3 * sampling, 1), H, W, C)."""

    x: torch.Tensor
    epoch: torch.Tensor  # int32, accepted count
    tau: torch.Tensor
    epsilon: torch.Tensor
    rejected: torch.Tensor  # int32
    attempts: torch.Tensor  # int32
    accepted: torch.Tensor  # int32
    mass_diag: torch.Tensor  # the diagonal metric
    samples: torch.Tensor
    last_decoded: torch.Tensor


def init_conditioned_chains(cfg: ConditionedHMCConfig, n_chains: int, x_shape, device="cuda",
                            generator: Optional[torch.Generator] = None,
                            x: Optional[torch.Tensor] = None) -> ConditionedChainState:
    """Fresh chains with x_T ~ N(0, I), or the given `x`, and M = 1."""
    x_shape = tuple(x_shape)
    if x is None:
        x = torch.randn((n_chains,) + x_shape, generator=generator, dtype=torch.float32,
                        device=device)
    n = x.shape[0]
    full = lambda v, dt: torch.full((n,), v, dtype=dt, device=device)
    return ConditionedChainState(
        x=x.to(device=device, dtype=torch.float32),
        epoch=full(0, torch.int32),
        tau=full(cfg.tau, torch.float32),
        epsilon=full(cfg.epsilon, torch.float32),
        rejected=full(0, torch.int32),
        attempts=full(0, torch.int32),
        accepted=full(0, torch.int32),
        mass_diag=torch.ones((n,) + x_shape, device=device),
        samples=torch.zeros((n, max(cfg.sampling * 3, 1)) + x_shape, device=device),
        last_decoded=torch.zeros((n,) + x_shape, device=device),
    )


def _rank_scores(variance: torch.Tensor) -> torch.Tensor:
    """Per chain, the ranks of the flattened variance scaled to [-1, 1]
    (nshmc_tpu/hmc/adaptation.py:199-207). The sort is stable, as
    jnp.argsort's: tied entries rank in index order."""
    flat = variance.reshape(variance.shape[0], -1)
    n = flat.shape[1]
    order = torch.argsort(flat, dim=1, stable=True)
    ranks = torch.zeros_like(flat, dtype=torch.float32).scatter_(
        1, order, torch.arange(n, dtype=torch.float32, device=flat.device).expand_as(flat))
    return (2.0 * ranks / (n - 1) - 1.0).reshape(variance.shape)


def _sigma_y(cfg: ConditionedHMCConfig, epoch: torch.Tensor) -> torch.Tensor:
    e = epoch.float()
    annealed = cfg.sigma_0 + cfg.anneal_scale * (
        1.0 - (e - cfg.burn) / cfg.epochs) ** cfg.anneal_power
    out = torch.where(epoch < cfg.burn, torch.full_like(e, cfg.sigma_0 + cfg.anneal_scale),
                      annealed)
    return torch.where(epoch >= cfg.epochs, torch.full_like(e, cfg.sigma_0), out)


def conditioned_attempt(loss_fn: LossFn, cfg: ConditionedHMCConfig,
                        state: ConditionedChainState,
                        generator: Optional[torch.Generator] = None,
                        p0: Optional[torch.Tensor] = None,
                        u: Optional[torch.Tensor] = None) -> ConditionedChainState:
    """One proposal for every chain (nshmc_tpu/hmc/adaptation.py:221-268)."""
    sigma_y = _sigma_y(cfg, state.epoch)
    switch = (state.epoch >= cfg.epochs) & (state.tau > cfg.post_tau)
    tau = torch.where(switch, torch.full_like(state.tau, cfg.post_tau), state.tau)
    eps = torch.where(switch, torch.full_like(state.epsilon, cfg.post_epsilon),
                      state.epsilon)

    accept, xp, dec, _, _, (_, m2) = leapfrog_propose(
        loss_fn, state.x, sigma_y, eps, cfg.n_leapfrog, generator=generator, p0=p0, u=u,
        mass_diag=state.mass_diag, collect_welford=True)

    # the mass update on accepted proposals past epochs // 3
    adapt = accept & (state.epoch > cfg.epochs // 3)
    mass_diag = state.mass_diag
    if bool(adapt.any()):
        variance = m2 / max(cfg.n_leapfrog - 1, 1)
        new_mass = torch.exp(cfg.mass_k * _rank_scores(variance))
        mass_diag = torch.where(_per_chain(adapt, mass_diag), new_mass, mass_diag)

    # The buffer has 3 * sampling slots, but the index runs to
    # burn + 3 * sampling - 1 and is clipped, so the last burn + 1 kept
    # samples all land in the final slot (as in the JAX package).
    sample_idx = state.epoch - (cfg.epochs + cfg.sampling)
    samples = write_samples(state.samples, accept & (sample_idx >= 0),
                            sample_idx.clamp(0, state.samples.shape[1] - 1), dec)

    rejected = state.rejected + 1
    backoff = rejected >= 2
    tau_r = torch.where(backoff, tau * cfg.backoff, tau)
    eps_r = torch.where(backoff, eps * cfg.backoff, eps)
    acc_i = accept.to(torch.int32)
    img = lambda a: _per_chain(accept, a)
    return ConditionedChainState(
        x=torch.where(img(xp), xp, state.x),
        epoch=state.epoch + acc_i,
        tau=torch.where(accept, tau, tau_r),
        epsilon=torch.where(accept, eps, eps_r),
        rejected=torch.where(accept, torch.zeros_like(rejected), rejected),
        attempts=state.attempts + 1,
        accepted=state.accepted + acc_i,
        mass_diag=mass_diag,
        samples=samples,
        last_decoded=torch.where(img(dec), dec, state.last_decoded),
    )


def run_conditioned_hmc(loss_fn: LossFn, cfg: ConditionedHMCConfig,
                        state: ConditionedChainState,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
                        callback=None, chain_chunk: int = 0) -> ConditionedChainState:
    """Every chain to its epoch budget, at most cfg.max_attempts attempts
    (nshmc_tpu/hmc/adaptation.py:271-290), through the engine's host loop
    (`drive`): a finished chain keeps its state while the others go on.
    `draws` optionally yields one (unit-normal p0, u) per attempt."""
    return drive(lambda s, p0, u: conditioned_attempt(loss_fn, cfg, s, p0=p0, u=u), state,
                 lambda s: (s.epoch < cfg.total_epochs) & (s.attempts < cfg.max_attempts),
                 cfg.max_attempts, "attempts", lambda s: draw_attempt(generator, s.x), draws,
                 callback, chain_chunk=chain_chunk)
