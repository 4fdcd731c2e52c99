"""ReSample: latent posterior sampling with hard data consistency (port of
nshmc_tpu/algos/resample.py).

A latent DPS step every timestep (the guidance through the differentiable
VQ decoder, with an extra 0.2 factor), and at every 20th timestep at or
below t = 200 a hard data-consistency solve (300 AdamW steps on
||H(decode(x0_hat)) - y0||^2) followed by a stochastic resample toward the
optimized latent. The branch spans cal_x0 and map_back, so ReSample
overrides `step`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..solvers.adamw import adamw_opt
from .base import Algo, grad_of, predict_eps, predict_x0, randn


def resamples_at(t: int) -> bool:
    """Whether step t runs the hard data-consistency solve."""
    return t % 20 == 0 and t <= 200


@dataclasses.dataclass(frozen=True)
class ReSample(Algo):
    decode_fn: Optional[Callable] = None
    gamma: float = 40.0
    eta: float = 0.85
    lam: float = 1.0
    inner_steps: int = 300
    inner_lr: float = 5e-3

    def draw(self, generator, xt):
        """The DPS step's noise, then the resample's: JAX's split(key)."""
        return randn(xt.shape, generator, xt), randn(xt.shape, generator, xt)

    def _dps_step(self, model_fn, xt, t, at, at_next, y0, noise):
        """Latent DPS with the gradient through the decoder."""
        def loss_fn(xt_in):
            et = predict_eps(model_fn, xt_in, t)
            x0 = predict_x0(xt_in, et, at)
            r = y0 - self.operator.H_img(self.decode_fn(x0))
            return torch.sum(r**2), (et, x0)

        loss, (et, x0), grad = grad_of(loss_fn, xt)
        if self.noise == "ddpm":
            c1 = self.eta * torch.sqrt((1 - at / at_next) * (1 - at_next) / (1 - at))
        else:
            c1 = torch.zeros((), dtype=torch.float32, device=xt.device)
        c2 = torch.sqrt(1 - at_next - c1**2)
        add_up = c1 * noise + c2 * et
        x0 = x0 - 0.2 * grad * self.lam / (torch.sqrt(at_next) * torch.sqrt(loss))
        return torch.sqrt(at_next) * x0 + add_up

    def _hard_consistency(self, model_fn, xt, xt_dps, t, at, at_next, y0, noise):
        """The data-consistency solve and the stochastic resample."""
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        x0_hat = adamw_opt(
            lambda x: torch.mean((self.operator.H_img(self.decode_fn(x)) - y0) ** 2),
            x0, self.inner_steps, self.inner_lr)
        sigma_t_sq = self.gamma * (1 - at_next) / at * (1 - at / at_next)
        var = sigma_t_sq * (1 - at_next) / (sigma_t_sq + 1 - at_next)
        mean = (1 - at_next) * xt_dps / (sigma_t_sq + 1 - at_next)
        add_up = mean + torch.sqrt(torch.clamp(var, min=0.0)) * noise
        return torch.where(
            sigma_t_sq > 0,
            sigma_t_sq * torch.sqrt(at_next) * x0_hat / (sigma_t_sq + 1 - at_next) + add_up,
            x0_hat)

    def step(self, model_fn, xt, state, t, at, at_next, y0, draws):
        dps_noise, resample_noise = draws
        xt_dps = self._dps_step(model_fn, xt, t, at, at_next, y0, dps_noise)
        if resamples_at(t):
            return self._hard_consistency(model_fn, xt, xt_dps, t, at, at_next, y0,
                                          resample_noise), state
        return xt_dps, state
