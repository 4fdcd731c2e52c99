"""Noise-space HMC engine (port of nshmc_tpu/hmc/engine.py).

The chains are the batch axis: one U-Net call serves every chain, and each
chain carries its own epoch, step size, rejection count and MH decision
(the JAX package vmaps one chain's program instead). Semantics, as there:
  - epoch = ACCEPTED-proposal count; a rejected proposal retries the epoch;
  - sigma_y = sigma_0 + 1.6 (1 - e/E)^2 during the first E epochs, then
    sigma_0; at e == E, (tau, eps) switch once to (0.1, 0.01);
  - after 2 consecutive rejections tau and eps decay by 0.95 (and keep
    decaying on each further rejection);
  - L = floor(tau_0 / eps_0) leapfrog steps, fixed up front;
  - U(x) = ||x||^2/2 + ||y0 - H(decode(x))||^2 / (2 sigma_y^2),
    K(p) = ||p||^2 / (2m); the stored sample of an accepted proposal is the
    decoded image of its last energy evaluation; NaN energies reject.

Randomness comes from a `torch.Generator`; `leapfrog_propose`,
`hmc_attempt` and `run_hmc` also take the momentum and accept-uniform
draws as inputs, so a test can replay the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Static sampler hyperparameters (nshmc_tpu/hmc/engine.py:42-66)."""

    sigma_0: float = 0.1  # measurement noise (already x2-scaled by caller)
    tau: float = 1.0
    epsilon: float = 0.05
    m: float = 1.0  # momentum mass
    epochs: int = 60  # annealing epochs
    sampling: int = 20  # burn-in = sampling, then `sampling` kept samples
    anneal_scale: float = 1.6
    anneal_power: float = 2.0
    post_tau: float = 0.1
    post_epsilon: float = 0.01
    backoff: float = 0.95
    max_attempts: int = 1000

    @property
    def n_leapfrog(self) -> int:
        return max(1, math.floor(self.tau / self.epsilon))

    @property
    def total_epochs(self) -> int:
        return self.epochs + 2 * self.sampling


@dataclasses.dataclass
class ChainState:
    """State of N chains; every field has the chain axis first.
    x: (N, H, W, C); samples: (N, sampling, H, W, C)."""

    x: torch.Tensor
    epoch: torch.Tensor  # int32, accepted count
    tau: torch.Tensor  # float32
    epsilon: torch.Tensor  # float32
    rejected: torch.Tensor  # int32, consecutive rejections
    attempts: torch.Tensor  # int32
    accepted: torch.Tensor  # int32
    samples: torch.Tensor
    last_decoded: torch.Tensor  # decoded image of the last accepted proposal
    last_loss: torch.Tensor  # data-fit loss at the last accepted proposal
    sigma_y: torch.Tensor  # current annealed measurement sigma

    def fields(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def init_chains(cfg: HMCConfig, n_chains: int, x_shape, device="cuda",
                generator: Optional[torch.Generator] = None,
                x: Optional[torch.Tensor] = None) -> ChainState:
    """Fresh chains with x_T ~ N(0, I), or the given `x` (N, *x_shape)."""
    x_shape = tuple(x_shape)
    if x is None:
        x = torch.randn((n_chains,) + x_shape, generator=generator,
                        dtype=torch.float32, device=device)
    n = x.shape[0]
    full = lambda v, dt: torch.full((n,), v, dtype=dt, device=device)
    return ChainState(
        x=x.to(device=device, dtype=torch.float32),
        epoch=full(0, torch.int32),
        tau=full(cfg.tau, torch.float32),
        epsilon=full(cfg.epsilon, torch.float32),
        rejected=full(0, torch.int32),
        attempts=full(0, torch.int32),
        accepted=full(0, torch.int32),
        samples=torch.zeros((n, cfg.sampling) + x_shape, device=device),
        last_decoded=torch.zeros((n,) + x_shape, device=device),
        last_loss=full(math.inf, torch.float32),
        sigma_y=full(cfg.sigma_0 + cfg.anneal_scale, torch.float32),
    )


LossFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
# loss_fn(x) -> (per-chain data loss (N,), decoded images); differentiable in x


def make_pixel_loss_fn(decode, operator, y0: torch.Tensor) -> LossFn:
    """U_data(x) = ||y0 - H(decode(x))||^2 per chain
    (nshmc_tpu/hmc/engine.py:111-120). y0: (d_y,)."""

    def loss_fn(x):
        x0 = decode(x)
        residual = y0[None] - operator.H_img(x0)
        return torch.sum(residual**2, dim=1), x0

    return loss_fn


def _sigma_y(cfg: HMCConfig, epoch: torch.Tensor) -> torch.Tensor:
    e = epoch.float()
    annealed = cfg.sigma_0 + cfg.anneal_scale * (1.0 - e / cfg.epochs) ** cfg.anneal_power
    return torch.where(epoch < cfg.epochs, annealed, torch.full_like(annealed, cfg.sigma_0))


def _per_chain(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N, 1, ..., 1) broadcastable against `like`."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _sum_chain(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def value_and_grad(loss_fn: LossFn, x: torch.Tensor):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, dec = loss_fn(x)
        (grad,) = torch.autograd.grad(loss.sum(), x)
    return loss.detach(), dec.detach(), grad


def leapfrog_propose(loss_fn: LossFn, x: torch.Tensor, sigma_y: torch.Tensor,
                     eps: torch.Tensor, n_leapfrog: int, m: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     p0: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None):
    """One leapfrog trajectory + per-chain MH decision
    (nshmc_tpu/hmc/engine.py:131-195): half step, L full steps, half-step
    correction. sigma_y, eps: (N,). p0 (N, ...) and u (N,) are drawn from
    `generator` unless given. Returns (accept, xp, dec, loss, log_ratio)."""
    sigma_y, eps = _per_chain(sigma_y, x), _per_chain(eps, x)
    inv2s2 = 1.0 / (2.0 * sigma_y**2)
    inv_mass = 1.0 / torch.tensor(m, dtype=x.dtype)

    def kinetic(p):
        return 0.5 * _sum_chain(inv_mass * p**2)

    if p0 is None:
        p0 = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                         device=x.device) * math.sqrt(m)
    loss0, dec, grad = value_and_grad(loss_fn, x)
    h0 = 0.5 * _sum_chain(x**2) + inv2s2.flatten() * loss0 + kinetic(p0)

    p = p0 - (eps / 2.0) * (x + inv2s2 * grad)
    xp, loss = x, loss0
    for _ in range(n_leapfrog):
        xp = xp + eps * inv_mass * p
        loss, dec, grad = value_and_grad(loss_fn, xp)
        p = p - eps * (xp + inv2s2 * grad)
    p = p + (eps / 2.0) * (xp + inv2s2 * grad)  # undo the last half over-step

    h1 = 0.5 * _sum_chain(xp**2) + inv2s2.flatten() * loss + kinetic(p)
    log_ratio = -(h1 - h0)
    if u is None:
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
    accept = (torch.log(u) < torch.clamp(log_ratio, max=0.0)) & torch.isfinite(log_ratio)
    return accept, xp, dec, loss, log_ratio


def hmc_attempt(loss_fn: LossFn, cfg: HMCConfig, state: ChainState,
                generator: Optional[torch.Generator] = None,
                p0: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None) -> Tuple[ChainState, torch.Tensor]:
    """One proposal for every chain (nshmc_tpu/hmc/engine.py:198-252).
    Returns (new state, log_ratio)."""
    sigma_y = _sigma_y(cfg, state.epoch)
    switch = (state.epoch >= cfg.epochs) & (state.tau > cfg.post_tau)
    tau = torch.where(switch, torch.full_like(state.tau, cfg.post_tau), state.tau)
    eps = torch.where(switch, torch.full_like(state.epsilon, cfg.post_epsilon),
                      state.epsilon)

    accept, xp, dec, loss, log_ratio = leapfrog_propose(
        loss_fn, state.x, sigma_y, eps, cfg.n_leapfrog, cfg.m, generator, p0, u)

    samples = state.samples
    if cfg.sampling > 0:
        sample_idx = state.epoch - (cfg.epochs + cfg.sampling)
        write = accept & (sample_idx >= 0)
        if bool(write.any()):
            samples = samples.clone()
            rows = write.nonzero().flatten()
            idx = sample_idx.clamp(0, cfg.sampling - 1).long()[rows]
            samples[rows, idx] = dec[rows]

    rejected = state.rejected + 1
    backoff = rejected >= 2
    tau_r = torch.where(backoff, tau * cfg.backoff, tau)
    eps_r = torch.where(backoff, eps * cfg.backoff, eps)
    acc_i = accept.to(torch.int32)
    img = lambda a: _per_chain(accept, a)
    new = ChainState(
        x=torch.where(img(xp), xp, state.x),
        epoch=state.epoch + acc_i,
        tau=torch.where(accept, tau, tau_r),
        epsilon=torch.where(accept, eps, eps_r),
        rejected=torch.where(accept, torch.zeros_like(rejected), rejected),
        attempts=state.attempts + 1,
        accepted=state.accepted + acc_i,
        samples=samples,
        last_decoded=torch.where(img(dec), dec, state.last_decoded),
        last_loss=torch.where(accept, loss, state.last_loss),
        sigma_y=sigma_y,
    )
    return new, log_ratio


def chains_active(cfg: HMCConfig, state: ChainState) -> torch.Tensor:
    """(N,) bool: chains that have neither finished nor run out of attempts."""
    return (state.epoch < cfg.total_epochs) & (state.attempts < cfg.max_attempts)


def run_hmc(loss_fn: LossFn, cfg: HMCConfig, state: ChainState,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
            callback=None) -> ChainState:
    """Run every chain to its epoch budget, at most cfg.max_attempts
    attempts (the host loop of nshmc_tpu/hmc/engine.py:315-408). A finished
    chain keeps its state while the others go on (it still rides along in
    the batch). `draws` optionally yields one (p0, u) per attempt round;
    `callback(state, round)` runs after each round."""
    draws = iter(draws) if draws is not None else None
    rnd = 0
    while rnd < cfg.max_attempts:
        active = chains_active(cfg, state)
        if not bool(active.any()):
            break
        p0, u = next(draws) if draws is not None else (None, None)
        new, _ = hmc_attempt(loss_fn, cfg, state, generator, p0, u)
        state = ChainState(**{
            name: torch.where(_per_chain(active, val), val, old)
            for (name, val), old in zip(new.fields().items(), state.fields().values())
        })
        if callback is not None:
            callback(state, rnd)
        rnd += 1
    return state
