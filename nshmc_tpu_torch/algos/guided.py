"""Gradient- and score-guided posterior samplers: DPS, PiGDM, DMPS, RED-diff
(port of nshmc_tpu/algos/guided.py).

  DPS      - likelihood-gradient guidance through the U-Net;
  PiGDM    - pseudo-inverse guidance with (HH^T + s^2)^-1;
  DMPS     - closed-form pseudo-likelihood guidance;
  RED-diff - variational regularization with carried state.

A gradient through the score network is `torch.autograd.grad` of a scalar
loss at a leaf copy of x_t (`grad_of`), the JAX package's
`jax.value_and_grad`; `jax.lax.stop_gradient` is `.detach()`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import Algo, grad_of, predict_eps, predict_x0


def _ddpm_coefficients(at, at_next, eta):
    """(c1, c2) of the eta-DDPM step's fresh noise and eps."""
    c1 = eta * torch.sqrt((1 - at / at_next) * (1 - at_next) / (1 - at))
    return c1, torch.sqrt(1 - at_next - c1**2)


@dataclasses.dataclass(frozen=True)
class DPS(Algo):
    """Diffusion posterior sampling."""

    lam: float = 1.0
    eta: float = 1.0

    def __post_init__(self):
        if self.noise not in ("ddpm", "ddim"):
            raise ValueError(f"unsupported noise type: {self.noise}")

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        def loss_fn(xt_in):
            et = predict_eps(model_fn, xt_in, t)
            x0 = predict_x0(xt_in, et, at)
            return torch.sum((y0 - self.operator.H_img(x0)) ** 2), (et, x0)

        loss, (et, x0), grad = grad_of(loss_fn, xt)
        if self.noise == "ddpm":
            c1, c2 = _ddpm_coefficients(at, at_next, self.eta)
        else:
            c1 = torch.zeros((), dtype=torch.float32, device=xt.device)
            c2 = torch.sqrt(1 - at_next - c1**2)
        add_up = c1 * draws[0] + c2 * et
        x0 = x0 - grad * self.lam / (torch.sqrt(at_next) * torch.sqrt(loss))
        return x0, add_up, state


@dataclasses.dataclass(frozen=True)
class PiGDM(Algo):
    """Pseudo-inverse guided diffusion."""

    lam: float = 1.0
    eta: float = 1.0

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        op = self.operator
        if self.sigma_0 == 0:
            def loss_fn(xt_in):
                et = predict_eps(model_fn, xt_in, t)
                x0 = predict_x0(xt_in, et, at)
                mat = (op.H_pinv(y0) - op.H_pinv(op.H_img(x0))).detach()
                return torch.sum(self._img(mat, x0) * x0), (et, x0)
        else:
            scale = self.sigma_0 / torch.sqrt(1 - at)

            def loss_fn(xt_in):
                et = predict_eps(model_fn, xt_in, t)
                x0 = predict_x0(xt_in, et, at)
                mat1 = op.Ut((y0 - op.H_img(x0)).detach())
                mat2 = op.H_scaled_inv(op.H_img(x0), scale)
                return torch.sum(mat1 * mat2), (et, x0)

        _, (et, x0), grad = grad_of(loss_fn, xt)
        c1, c2 = _ddpm_coefficients(at, at_next, self.eta)
        add_up = c1 * draws[0] + c2 * et
        x0 = x0 + torch.sqrt(at) / torch.sqrt(at_next) * grad * self.lam
        return x0, add_up, state


@dataclasses.dataclass(frozen=True)
class DMPS(Algo):
    """Diffusion model posterior sampling with the closed-form
    pseudo-likelihood (the operator's `H_dmps_guidance`)."""

    eta: float = 0.85

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        op = self.operator
        guidance = self._img(op.H_dmps_guidance(self._flat(xt), y0, at, self.sigma_0), xt)
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        c1 = self.eta * torch.sqrt(1 - at_next)
        c2 = math.sqrt(1 - self.eta**2) * torch.sqrt(1 - at_next)
        at_no_bar = at / at_next
        x0 = x0 + (1 - at_no_bar) / (torch.sqrt(at_no_bar) * torch.sqrt(at_next)) * guidance
        return x0, c1 * draws[0] + c2 * et, state


@dataclasses.dataclass(frozen=True)
class REDdiff(Algo):
    """RED-diff with the carried state (x0_t_last, initialized)."""

    eta: float = 2.0

    def init_state(self, xt):
        return (torch.zeros_like(xt), False)

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        x0_last_stored, initialized = state
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        x0_last = x0_last_stored if initialized else x0  # the first step starts at x0

        _, _, grad = grad_of(
            lambda x: (torch.sum((y0 - self.operator.H_img(x)) ** 2), ()), x0_last)
        add_up = torch.sqrt(1 - at_next) * draws[0]
        x0_new = x0_last + (x0 - x0_last) - grad * self.eta
        # the carried x0_t_last is the UPDATED x0
        return x0_new, add_up, (x0_new, True)
