"""Optimization-in-the-loop samplers: DiffPIR and DAPS (port of
nshmc_tpu/algos/optim_based.py).

  DiffPIR - 50 schedule-free-AdamW proximal steps per outer DDIM step on
            ||H(xhat)-y||^2 + rho_t ||xhat - x0||^2;
  DAPS    - a probability-flow ODE sub-solver (order-5 step subdivision)
            and then N = 100 Langevin steps on the data-consistency
            posterior, as its own sampler (`run_daps`): the inner ODE ladder
            depends on the outer timestep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import torch

from ..schedules import DDIMSequence, DiffusionSchedule
from ..solvers.sf_adamw import sf_adamw_init, sf_adamw_step
from .base import Algo, ModelFn, grad_of, predict_eps, predict_x0, randn


@dataclasses.dataclass(frozen=True)
class DiffPIR(Algo):
    """Plug-and-play prior with an inner proximal solve."""

    lam: float = 7.0
    eta: float = 0.85
    lr: float = 0.1
    inner_steps: int = 50

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        op = self.operator
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        sigma_bar_sq = torch.clamp((1 - at) / at, min=1e-8)
        rho_t = self.lam * self.sigma_0**2 / sigma_bar_sq

        def inner_loss(xhat):
            loss = torch.sum((op.H_img(xhat) - y0) ** 2) + rho_t * torch.sum((xhat - x0) ** 2)
            return loss, ()

        xhat, opt_state = x0, sf_adamw_init(x0)
        for _ in range(self.inner_steps):
            g = grad_of(inner_loss, xhat)[2]
            xhat, opt_state = sf_adamw_step(xhat, g, opt_state, lr=self.lr)
        et_new = xt / torch.sqrt(1 - at)
        add_up = torch.sqrt(1 - at_next) * (math.sqrt(1 - self.eta**2) * et_new
                                            + self.eta * draws[0])
        return xhat, add_up, state

    def map_back(self, x0_t, y0, add_up, at_next, at):
        # DiffPIR's extra correction term
        return (torch.sqrt(at_next) * x0_t + add_up
                - torch.sqrt(at) * x0_t / torch.sqrt(1 - at)
                * torch.sqrt(1 - at_next) * math.sqrt(1 - self.eta**2))


@dataclasses.dataclass(frozen=True)
class DAPS(Algo):
    """Decoupled annealed posterior sampling."""

    eta0: float = 1e-4
    delta: float = 1e-2
    order: int = 5
    nonlinear: bool = False
    langevin_steps: int = 100
    langevin_sigma: float = 0.02

    def draw(self, generator, xt):
        """The Langevin noises (langevin_steps, *x.shape), then the outer
        noise: JAX's split(key, 3) and split(k_lan, langevin_steps)."""
        return (randn((self.langevin_steps, *xt.shape), generator, xt),
                randn(xt.shape, generator, xt))

    def ode(self, model_fn, schedule: DiffusionSchedule, xt, t: int):
        """The probability-flow ODE from t to 0 in `order - 1` segments."""
        skip = t // (self.order - 1)
        seq = list(range(0, t, skip)) if skip > 0 else [0]
        seq = seq[1:] + [t]
        seq_next = [-1] + seq[:-1]
        for i, j in zip(reversed(seq), reversed(seq_next)):
            at, at_next = schedule.alpha_bar(i), schedule.alpha_bar(j)
            et = predict_eps(model_fn, xt, float(i))
            x0 = predict_x0(xt, et, at)
            xt = torch.sqrt(at_next) * x0 + torch.sqrt(1 - at_next) * et
        return xt

    def langevin(self, x0, y0, eta: float, at, noises):
        """Unadjusted Langevin steps on the data-consistency posterior, one
        for each of `noises`."""
        op = self.operator
        rt = torch.clamp(torch.sqrt(1 - at), min=1e-4)
        sigma_0 = self.langevin_sigma
        if self.sigma_0 == 0 and not self.nonlinear:
            def loss_fn(x):
                return torch.sum((op.H_img(x) - y0) ** 2) / eta / 2.0, ()
        else:
            def loss_fn(x):
                return (torch.sum((x - x0) ** 2) / (2 * rt**2)
                        + torch.sum((op.H_img(x) - y0) ** 2) / (2 * sigma_0**2)), ()

        x = x0
        for noise in noises:
            x = x - eta * grad_of(loss_fn, x)[2] + math.sqrt(2 * eta) * noise
        return x


@torch.no_grad()
def run_daps(model_fn: ModelFn, schedule: DiffusionSchedule, seq: DDIMSequence, algo: DAPS,
             xt: torch.Tensor, y0: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[Iterable[tuple]] = None, num_timesteps: int = 1000) -> torch.Tensor:
    """DAPS's outer loop over the DDIM ladder; each step's draws from
    `algo.draw(generator, xt)` or the next of `draws`."""
    draws = iter(draws) if draws is not None else None
    for t, t_next in zip(reversed(seq.seq), reversed(seq.seq_next)):
        lan, noise = next(draws) if draws is not None else algo.draw(generator, xt)
        at, at_next = schedule.alpha_bar(t), schedule.alpha_bar(t_next)
        x0 = algo.ode(model_fn, schedule, xt, int(t))
        eta = algo.eta0 * (algo.delta + t / num_timesteps * (1 - algo.delta))
        x0 = algo.langevin(x0, y0, eta, at, lan)
        xt = torch.sqrt(at_next) * x0 + torch.sqrt(1 - at_next) * noise
    return xt
