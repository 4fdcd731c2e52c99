"""Noise-space HMC engine (port of nshmc_tpu/hmc/engine.py).

The chains are the batch axis: one U-Net call serves every chain, and each
chain carries its own epoch, step size, rejection count and MH decision
(the JAX package vmaps one chain's program instead). Semantics, as there:
  - epoch = ACCEPTED-proposal count; a rejected proposal retries the epoch;
  - sigma_y = sigma_0 + 1.6 (1 - e/E)^2 during the first E epochs, then
    sigma_0; at e == E, (tau, eps) switch once to (0.1, 0.01);
  - after 2 consecutive rejections tau and eps decay by 0.95 (and keep
    decaying on each further rejection, unless reset_rejected_after_backoff);
  - L = floor(tau_0 / eps_0) leapfrog steps, fixed up front;
  - U(x) = ||x||^2/2 + ||y0 - H(decode(x))||^2 / (2 sigma_y^2),
    K(p) = sum p^2 / (2 M) with M = m or a diagonal metric; the stored
    sample of an accepted proposal is the decoded image of its last energy
    evaluation; NaN energies reject.

Randomness comes from a `torch.Generator`; `leapfrog_propose`,
`hmc_attempt` and the drivers also take the momentum and accept-uniform
draws as inputs, so a test can replay the JAX package's draws. An injected
momentum is the UNIT normal: the engine scales it by sqrt(M) itself, as the
JAX package scales its own draw. Each attempt draws the momenta of all
chains and then their uniforms, in that order, so a run whose chains go
through the U-Net in waves (`chain_chunk`) equals one that does not.

`run_hmc` is also the port of the JAX package's observed driver
(`run_hmc_observed`): a host loop that calls back after each round of
`attempts_per_round` attempts and, with a `checkpoint_dir`, snapshots the
chain state and the generator's state every `checkpoint_every` attempts and
at the end, and resumes from the snapshot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from ..utils import checkpointing, profiling


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
    reset_rejected_after_backoff: bool = False
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
    (nshmc_tpu/hmc/engine.py:111-120). y0: (d_y,), shared by every chain, or
    (N, d_y), one row per chain (`run_hmc_multi`)."""
    y0 = y0[None] if y0.dim() == 1 else y0

    def loss_fn(x):
        x0 = decode(x)
        with profiling.span("operator"):
            residual = y0 - operator.H_img(x0)
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


# --- chain states as a whole (any dataclass whose fields have the chain axis first) ---

def _replace(state, fn):
    return type(state)(**{f.name: fn(f.name, getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def _select(mask: torch.Tensor, new, old):
    """Per chain: `new` where `mask`, else `old`."""
    return _replace(old, lambda name, o: torch.where(_per_chain(mask, o), getattr(new, name), o))


def _chains(state, start: int, stop: int):
    return _replace(state, lambda name, v: v[start:stop])


def _concat(states: Sequence):
    return _replace(states[0], lambda name, v: torch.cat([getattr(s, name) for s in states]))


def value_and_grad(loss_fn: LossFn, x: torch.Tensor):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        with profiling.span("hmc.forward"):
            loss, dec = loss_fn(x)
        with profiling.span("hmc.backward"):
            (grad,) = torch.autograd.grad(loss.sum(), x)
    return loss.detach(), dec.detach(), grad


def _any(mask: torch.Tensor) -> bool:
    """mask.any() read on the host: a synchronisation with the device."""
    with profiling.span("hmc.sync"):
        return bool(mask.any())


def draw_attempt(generator: Optional[torch.Generator], x: torch.Tensor):
    """One attempt's draws for the chains of `x`: unit-normal momenta like
    x, then the accept uniforms (N,), in the order leapfrog_propose draws
    them."""
    p0 = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    u = torch.rand((x.shape[0],), generator=generator, device=x.device)
    return p0, u


def leapfrog_propose(loss_fn: LossFn, x: torch.Tensor, sigma_y: torch.Tensor,
                     eps: torch.Tensor, n_leapfrog: int, m: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     p0: Optional[torch.Tensor] = None,
                     u: Optional[torch.Tensor] = None,
                     mass_diag: Optional[torch.Tensor] = None,
                     collect_welford: bool = False):
    """One leapfrog trajectory + per-chain MH decision
    (nshmc_tpu/hmc/engine.py:131-195): half step, L full steps, half-step
    correction. sigma_y, eps: (N,). The unit-normal momenta p0 (N, ...)
    and the uniforms u (N,) are drawn from `generator` unless given; the
    momenta are scaled by sqrt(M), M = mass_diag (N, ...) or m. Returns
    (accept, xp, dec, loss, log_ratio), and with `collect_welford` also
    (mean, m2): the Welford running mean and M2 of the L trajectory
    positions (the mass-matrix adaptation's statistics)."""
    sigma_y, eps = _per_chain(sigma_y, x), _per_chain(eps, x)
    inv2s2 = 1.0 / (2.0 * sigma_y**2)
    if mass_diag is not None:
        mass = mass_diag
    else:
        with profiling.span("hmc.sync"):  # a copy from pageable host memory waits for the stream
            mass = torch.tensor(m, dtype=x.dtype, device=x.device)
    inv_mass = 1.0 / mass

    def kinetic(p):
        return 0.5 * _sum_chain(inv_mass * p**2)

    if p0 is None:
        p0 = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    p0 = p0 * torch.sqrt(mass)
    loss0, dec, grad = value_and_grad(loss_fn, x)
    h0 = 0.5 * _sum_chain(x**2) + inv2s2.flatten() * loss0 + kinetic(p0)

    p = p0 - (eps / 2.0) * (x + inv2s2 * grad)
    xp, loss = x, loss0
    if collect_welford:
        mean = m2 = torch.zeros_like(x)
    for step in range(n_leapfrog):
        with profiling.span("hmc.leapfrog_step"):
            xp = xp + eps * inv_mass * p
            loss, dec, grad = value_and_grad(loss_fn, xp)
            p = p - eps * (xp + inv2s2 * grad)
            if collect_welford:
                delta = xp - mean
                mean = mean + delta / torch.tensor(step + 1, dtype=x.dtype)
                m2 = m2 + delta * (xp - mean)
    p = p + (eps / 2.0) * (xp + inv2s2 * grad)  # undo the last half over-step

    h1 = 0.5 * _sum_chain(xp**2) + inv2s2.flatten() * loss + kinetic(p)
    log_ratio = -(h1 - h0)
    if u is None:
        u = torch.rand((x.shape[0],), generator=generator, device=x.device)
    accept = (torch.log(u) < torch.clamp(log_ratio, max=0.0)) & torch.isfinite(log_ratio)
    if collect_welford:
        return accept, xp, dec, loss, log_ratio, (mean, m2)
    return accept, xp, dec, loss, log_ratio


def write_samples(samples: torch.Tensor, write: torch.Tensor, idx: torch.Tensor,
                  dec: torch.Tensor) -> torch.Tensor:
    """samples[c, idx[c]] = dec[c] for the chains c where `write`."""
    if not _any(write):
        return samples
    samples = samples.clone()
    with profiling.span("hmc.sync"):  # nonzero's size is read on the host
        rows = write.nonzero().flatten()
    samples[rows, idx.long()[rows]] = dec[rows]
    return samples


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
        samples = write_samples(samples, accept & (sample_idx >= 0),
                                sample_idx.clamp(0, cfg.sampling - 1), dec)

    rejected = state.rejected + 1
    backoff = rejected >= 2
    tau_r = torch.where(backoff, tau * cfg.backoff, tau)
    eps_r = torch.where(backoff, eps * cfg.backoff, eps)
    if cfg.reset_rejected_after_backoff:
        rejected = torch.where(backoff, torch.zeros_like(rejected), rejected)
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


Attempt = Callable[[object, torch.Tensor, torch.Tensor], object]
# attempt(state, p0, u) -> new state, for the chains of `state`


def attempt_in_waves(attempt: Attempt, state, p0: torch.Tensor, u: torch.Tensor,
                     chain_chunk: int = 0):
    """`attempt` over the chains in sequential waves of `chain_chunk` chains
    (0: all at once), the draws already made for every chain, so the result
    does not depend on the chunk (nshmc_tpu/hmc/engine.py:296-312). Each
    wave's autograd graphs are freed before the next starts: the memory
    high-water mark is one wave's."""
    n = p0.shape[0]
    if chain_chunk <= 0 or n <= chain_chunk:
        return attempt(state, p0, u)
    if n % chain_chunk != 0:
        raise ValueError(f"chain count {n} not divisible by chain_chunk {chain_chunk}")
    return _concat([attempt(_chains(state, a, a + chain_chunk), p0[a:a + chain_chunk],
                            u[a:a + chain_chunk]) for a in range(0, n, chain_chunk)])


def drive(attempt: Attempt, state, active: Callable, rounds: int, counter: str,
          draw: Callable, draws: Optional[Iterable] = None, callback=None,
          checkpoint_dir: str = "", checkpoint_every: int = 10,
          attempts_per_round: int = 1, chain_chunk: int = 0,
          generators: Sequence[torch.Generator] = ()):
    """The observed host loop of every noise-space sampler
    (nshmc_tpu/hmc/engine.py:315-408). Attempts until no chain is
    `active(state)` or `rounds` attempts are done; a chain that is not
    active keeps its state. `draw(state)` makes one attempt's (p0, u) unless
    `draws` yields them. `callback(state, round)` runs after each round of
    `attempts_per_round` attempts, a grouping that changes no statistic.
    With `checkpoint_dir`, the state and the `generators`' states are saved
    every `checkpoint_every` attempts (counted as the JAX driver counts
    them) and at the end, and a run resumes from the saved snapshot at round
    max(state.<counter>)."""
    apr = max(1, int(attempts_per_round))
    rnd = 0
    if checkpoint_dir:
        restored = checkpointing.load_chain_state(checkpoint_dir, state, generators=generators)
        if restored is not None:
            state = restored
            rnd = int(getattr(state, counter).max())
    draws = iter(draws) if draws is not None else None
    since_save = 0
    while rnd < rounds:
        if not _any(active(state)):
            break
        for _ in range(apr):
            with profiling.span("hmc.attempt", attempt=True):
                live = active(state)
                if not _any(live):
                    break
                p0, u = next(draws) if draws is not None else draw(state)
                state = _select(live, attempt_in_waves(attempt, state, p0, u, chain_chunk),
                                state)
        rnd += apr
        if callback is not None:
            callback(state, rnd - 1)
        since_save += apr
        if checkpoint_dir and since_save >= checkpoint_every:
            checkpointing.save_chain_state(checkpoint_dir, state, generators=generators)
            since_save = 0
    if checkpoint_dir:
        checkpointing.save_chain_state(checkpoint_dir, state, generators=generators)
    return state


def run_hmc(loss_fn: LossFn, cfg: HMCConfig, state: ChainState,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
            callback=None, checkpoint_dir: str = "", checkpoint_every: int = 10,
            attempts_per_round: int = 1, chain_chunk: int = 0) -> ChainState:
    """Run every chain to its epoch budget, at most cfg.max_attempts
    attempts (`drive`). A finished chain keeps its state while the others
    go on (it still rides along in the batch). `draws` optionally yields one
    (unit-normal p0, u) per attempt; `callback(state, round)` runs after
    each round. `chain_chunk` > 0 sends the chains through the U-Net in
    waves of that many; N must be a multiple of it."""
    return drive(lambda s, p0, u: hmc_attempt(loss_fn, cfg, s, p0=p0, u=u)[0], state,
                 lambda s: chains_active(cfg, s), cfg.max_attempts, "attempts",
                 lambda s: draw_attempt(generator, s.x), draws, callback, checkpoint_dir,
                 checkpoint_every, attempts_per_round, chain_chunk,
                 (generator,) if generator is not None else ())


def run_hmc_multi(loss_fn_builder, cfg: HMCConfig, state: ChainState, y0s: torch.Tensor,
                  generators: Sequence[torch.Generator] = (),
                  draws: Optional[Iterable[Tuple[torch.Tensor, torch.Tensor]]] = None,
                  callback=None) -> ChainState:
    """I images x N chains as one batch of I * N chains, image-major
    (nshmc_tpu/hmc/engine.py:282-293). y0s: (I, d_y); image i's chains see
    its row through `loss_fn_builder(y0 rows (I * N, d_y))`. Image i's
    chains draw from `generators[i]`, so each image's chains take the draws
    it would take run alone with that generator; `draws` optionally yields
    one (p0, u) of all I * N chains per attempt."""
    n_images = y0s.shape[0]
    per_image = state.x.shape[0] // n_images
    loss_fn = loss_fn_builder(y0s.repeat_interleave(per_image, dim=0))

    def draw(s):
        parts = [draw_attempt(g, s.x[i * per_image:(i + 1) * per_image])
                 for i, g in enumerate(generators)]
        return torch.cat([p for p, _ in parts]), torch.cat([u for _, u in parts])

    return drive(lambda s, p0, u: hmc_attempt(loss_fn, cfg, s, p0=p0, u=u)[0], state,
                 lambda s: chains_active(cfg, s), cfg.max_attempts, "attempts", draw, draws,
                 callback)
