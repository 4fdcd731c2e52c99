"""Latent-space noise-space HMC (port of nshmc_tpu/hmc/latent.py).

The chains are the batch axis, as in the pixel engine (hmc/engine.py), and
share its leapfrog integrator and MH decision (`leapfrog_propose`). What
differs from the pixel sampler, as in the JAX package:
  - epochs count ATTEMPTS, not accepted proposals: every chain runs
    epochs + 2 * sampling attempts;
  - sigma_y follows a GEOMETRIC anneal sigma_y0 * (sigma_0 / sigma_y0)^(e/E),
    e the attempt index, updated only ON ACCEPT during the anneal; after it,
    every accept re-pins sigma_y = sigma_0 and (tau, eps) = (0.1, 0.01);
  - after 2 consecutive rejections tau and eps back off x0.9 and the
    rejection counter RESETS;
  - a ring of `keep_samples` z0 latents keeps, on each post-anneal accept,
    the z0 of the PREVIOUS accepted proposal;
  - last_loss starts at inf.

The loss decodes z_T through the latent DDIM ladder and the VQ decoder,
||y0 - H(decode_first_stage(ddim(z)))||^2 per chain; the eps-net's
stop-gradient (the reference's @torch.no_grad apply_model) is the caller's
model_fn (models/ldm/ldm.py::LatentDiffusion.model_fn).

Randomness comes from a `torch.Generator`; `latent_hmc_attempt` and
`run_latent_hmc` also take the (unit-normal) momentum and accept-uniform
draws as inputs, so a test can replay the JAX package's draws.
`run_latent_hmc` is also the port of `run_latent_hmc_observed`: snapshots
and resume, rounds of `attempts_per_round` attempts and chain waves, through
the pixel engine's host loop (`engine.drive`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import torch

from ..utils import profiling
from .engine import LossFn, _per_chain, draw_attempt, drive, leapfrog_propose


@dataclasses.dataclass(frozen=True)
class LatentHMCConfig:
    """Static sampler hyperparameters (nshmc_tpu/hmc/latent.py:33-57)."""

    sigma_0: float = 0.1  # final measurement sigma (x2-scaled by the caller)
    sigma_y0: float = 1.0  # geometric anneal start (--sigma_y)
    tau: float = 1.0
    epsilon: float = 0.05
    m: float = 1.0
    epochs: int = 50  # anneal attempts
    sampling: int = 10  # post-anneal: 2 * sampling more attempts
    post_tau: float = 0.1
    post_epsilon: float = 0.01
    backoff: float = 0.9
    keep_samples: int = 10

    @property
    def n_leapfrog(self) -> int:
        return max(1, math.floor(self.tau / self.epsilon))

    @property
    def total_attempts(self) -> int:
        return self.epochs + 2 * self.sampling


@dataclasses.dataclass
class LatentChainState:
    """State of N chains, the chain axis first; the JAX package's field
    names (its PRNG key is the caller's generator here).
    z, last_z0_accept: (N, *z_shape); samples: (N, keep_samples, *z_shape)."""

    z: torch.Tensor
    attempt: torch.Tensor  # int32
    accepted: torch.Tensor  # int32
    rejected: torch.Tensor  # int32, consecutive rejections since the last backoff
    tau: torch.Tensor
    epsilon: torch.Tensor
    sigma_y: torch.Tensor
    samples: torch.Tensor  # ring of z0 latents, newest last
    n_kept: torch.Tensor  # int32
    last_z0_accept: torch.Tensor  # DDIM-decoded z0 of the last accept
    last_loss: torch.Tensor
    last_log_ratio: torch.Tensor  # MH log-ratio of the last proposal


def init_latent_chains(cfg: LatentHMCConfig, n_chains: int, z_shape, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       z: Optional[torch.Tensor] = None) -> LatentChainState:
    """Fresh chains with z_T ~ N(0, I), or the given `z` (N, *z_shape)."""
    z_shape = tuple(z_shape)
    if z is None:
        z = torch.randn((n_chains,) + z_shape, generator=generator, dtype=torch.float32,
                        device=device)
    n = z.shape[0]
    full = lambda v, dt: torch.full((n,), v, dtype=dt, device=device)
    return LatentChainState(
        z=z.to(device=device, dtype=torch.float32),
        attempt=full(0, torch.int32),
        accepted=full(0, torch.int32),
        rejected=full(0, torch.int32),
        tau=full(cfg.tau, torch.float32),
        epsilon=full(cfg.epsilon, torch.float32),
        sigma_y=full(cfg.sigma_y0, torch.float32),
        samples=torch.zeros((n, cfg.keep_samples) + z_shape, device=device),
        n_kept=full(0, torch.int32),
        last_z0_accept=torch.zeros((n,) + z_shape, device=device),
        last_loss=full(math.inf, torch.float32),
        last_log_ratio=full(0.0, torch.float32),
    )


def latent_hmc_attempt(loss_fn: LossFn, cfg: LatentHMCConfig, state: LatentChainState,
                       generator: Optional[torch.Generator] = None,
                       p0: Optional[torch.Tensor] = None,
                       u: Optional[torch.Tensor] = None) -> LatentChainState:
    """One proposal for every chain (nshmc_tpu/hmc/latent.py:84-142)."""
    accept, zp, dec_z, loss, log_ratio = leapfrog_propose(
        loss_fn, state.z, state.sigma_y, state.epsilon, cfg.n_leapfrog, cfg.m, generator,
        p0, u)

    in_anneal = state.attempt < cfg.epochs
    e = state.attempt.float()
    sigma_anneal = cfg.sigma_y0 * (cfg.sigma_0 / cfg.sigma_y0) ** (e / cfg.epochs)
    new_sigma = torch.where(in_anneal, sigma_anneal, torch.full_like(sigma_anneal, cfg.sigma_0))
    sigma_y = torch.where(accept, new_sigma, state.sigma_y)
    pin = accept & ~in_anneal  # post-anneal accepts pin (tau, eps) and keep a sample
    tau = torch.where(pin, torch.full_like(state.tau, cfg.post_tau), state.tau)
    eps = torch.where(pin, torch.full_like(state.epsilon, cfg.post_epsilon), state.epsilon)

    shifted = torch.cat([state.samples[:, 1:], state.last_z0_accept[:, None]], dim=1)
    samples = torch.where(_per_chain(pin, shifted), shifted, state.samples)

    rejected = state.rejected + 1
    backoff = rejected >= 2
    tau_r = torch.where(backoff, tau * cfg.backoff, tau)
    eps_r = torch.where(backoff, eps * cfg.backoff, eps)
    rejected = torch.where(backoff, torch.zeros_like(rejected), rejected)

    img = lambda a: _per_chain(accept, a)
    acc_i = accept.to(torch.int32)
    return LatentChainState(
        z=torch.where(img(zp), zp, state.z),
        attempt=state.attempt + 1,
        accepted=state.accepted + acc_i,
        rejected=torch.where(accept, torch.zeros_like(rejected), rejected),
        tau=torch.where(accept, tau, tau_r),
        epsilon=torch.where(accept, eps, eps_r),
        sigma_y=sigma_y,
        samples=samples,
        n_kept=state.n_kept + pin.to(torch.int32),
        last_z0_accept=torch.where(img(dec_z), dec_z, state.last_z0_accept),
        last_loss=torch.where(accept, loss, state.last_loss),
        last_log_ratio=log_ratio,
    )


def run_latent_hmc(loss_fn: LossFn, cfg: LatentHMCConfig, state: LatentChainState,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
                   callback=None, checkpoint_dir: str = "", checkpoint_every: int = 10,
                   attempts_per_round: int = 1, chain_chunk: int = 0) -> LatentChainState:
    """Every chain's epochs + 2 * sampling attempts, one attempt for all
    chains at a time (nshmc_tpu/hmc/latent.py:164-239). `draws` optionally
    yields one (unit-normal p0, u) per attempt; `callback(state, round)`
    runs after each round of `attempts_per_round` attempts. With
    `checkpoint_dir`, snapshots every `checkpoint_every` attempts and at the
    end, and resumes at attempt max(state.attempt). `chain_chunk` > 0 sends
    the chains through the networks in waves of that many."""
    return drive(lambda s, p0, u: latent_hmc_attempt(loss_fn, cfg, s, p0=p0, u=u), state,
                 lambda s: s.attempt < cfg.total_attempts, cfg.total_attempts, "attempt",
                 lambda s: draw_attempt(generator, s.z), draws, callback, checkpoint_dir,
                 checkpoint_every, attempts_per_round, chain_chunk,
                 (generator,) if generator is not None else ())


def make_latent_loss_fn(ddim_decode_z, decode_first_stage, operator, y0: torch.Tensor) -> LossFn:
    """loss(z) = ||y0 - H(decode_first_stage(ddim(z)))||^2 per chain, with
    the DDIM-decoded z0 as the decoded output
    (nshmc_tpu/hmc/latent.py:242-267). y0: (d_y,)."""

    def loss_fn(z):
        z0 = ddim_decode_z(z)
        with profiling.span("vq.decode"):
            img = decode_first_stage(z0)
        with profiling.span("operator"):
            residual = y0[None] - operator.H_img(img)
        return torch.sum(residual**2, dim=1), z0

    return loss_fn
