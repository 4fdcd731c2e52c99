"""The original ReSample sampler, a DDIM sampler of its own (port of
nshmc_tpu/sampling/resample_original.py).

  make_ddim_timesteps / make_ddim_alphas - the uniform DDIM timestep subset
     (+1 shift) and its alpha tables;
  resample_original_sample - each step an eta-DDIM step with DPS guidance
     through the differentiable decoder (scale a_t * 0.5 on the gradient of
     the L2 norm of the residual), and every 5th index in the later 2/3 of
     the trajectory a time-travel: while index >= total/3 a pixel-space
     solve (50 AdamW steps, lr 1e-2), encoded back to the latent, else a
     latent solve (25 steps, lr 5e-3), each followed by a stochastic
     resample; a final latent solve at the end. The inner solves run fixed
     budgets, as the JAX package's do.

The eps-net is a constant of every gradient (stop-grad, as in the
reference), so the guidance reaches the latent through the decoder only.
Each step draws the eta-DDIM noise and then the time-travel noise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..algos.base import grad_of, randn
from ..schedules import DiffusionSchedule
from ..solvers.adamw import adamw_opt


@dataclasses.dataclass(frozen=True)
class ResampleOriginalConfig:
    ddim_steps: int = 500
    eta: float = 0.0
    gamma: float = 40.0  # the sigma scale of the time-travel
    travel_every: int = 5
    splits: int = 3
    pixel_opt_iters: int = 50
    pixel_opt_lr: float = 1e-2
    latent_opt_iters: int = 25
    latent_opt_lr: float = 5e-3


def make_ddim_timesteps(num_ddim: int, num_ddpm: int) -> np.ndarray:
    """The uniform subset, shifted by +1."""
    c = num_ddpm // num_ddim
    return np.asarray(range(0, num_ddpm, c)) + 1


def make_ddim_alphas(schedule: DiffusionSchedule, timesteps: np.ndarray, eta: float):
    """(alphas, alphas_prev, sigmas), float32 numpy: alpha-bar indexed at the
    +1-shifted timesteps directly."""
    ac = schedule.alphas_cumprod.cpu().numpy()
    alphas = ac[timesteps]
    alphas_prev = np.concatenate([[ac[0]], ac[timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return alphas, alphas_prev, sigmas


def stochastic_resample(pred_x0, x_t, a_t, sigma, noise):
    """The resample toward pred_x0; `noise` a standard-normal draw of
    pred_x0's shape."""
    var = 1.0 / (1.0 / sigma + 1.0 / (1.0 - a_t))
    return ((sigma * torch.sqrt(a_t) * pred_x0 + (1 - a_t) * x_t) / (sigma + 1 - a_t)
            + noise * torch.sqrt(var))


def travel_stage(index: int, total: int, cfg: ResampleOriginalConfig) -> Optional[str]:
    """"pixel", "latent" or None: the time-travel of step `index`."""
    split = total // cfg.splits
    if index <= total - split and index > 0 and index % cfg.travel_every == 0:
        return "pixel" if index >= split else "latent"
    return None


@torch.no_grad()
def resample_original_sample(model_fn: Callable, schedule: DiffusionSchedule,
                             decode_fn: Callable, encode_fn: Callable, operator,
                             y0: torch.Tensor, z_T: torch.Tensor,
                             cfg: ResampleOriginalConfig = ResampleOriginalConfig(),
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[Iterable[tuple]] = None,
                             travel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the whole trajectory; returns the final latent. `model_fn`, the
    eps model, runs without autograd whatever it is. Each step's (eta-DDIM noise, travel noise) come from
    `generator` or the next of `draws`; `travel_noise` ((steps,) +
    z_T.shape), where given, replaces the travel draws."""
    timesteps = make_ddim_timesteps(cfg.ddim_steps, schedule.num_timesteps)
    alphas, alphas_prev, sigmas = make_ddim_alphas(schedule, timesteps, cfg.eta)
    total = len(timesteps)
    if travel_noise is not None and tuple(travel_noise.shape) != (total, *z_T.shape):
        raise ValueError(f"travel_noise {tuple(travel_noise.shape)} is not "
                         f"{(total, *z_T.shape)}")
    f32 = lambda v: torch.tensor(np.float32(v), device=z_T.device)
    draws = iter(draws) if draws is not None else None

    def data_loss(z):
        return torch.mean((y0 - operator.H_img(decode_fn(z))) ** 2)

    def sigma_of(a_prev, a_t):
        return cfg.gamma * (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)

    img = z_T
    for i, index in enumerate(range(total - 1, -1, -1)):
        step, a_t = f32(timesteps[index]), f32(alphas[index])
        a_prev, sigma_t = f32(alphas_prev[index]), f32(sigmas[index])
        noise, tnoise = next(draws) if draws is not None else (
            randn(img.shape, generator, img), randn(img.shape, generator, img))
        if travel_noise is not None:
            tnoise = travel_noise[i]

        def guided(img_in):
            tb = torch.full((img_in.shape[0],), float(step), device=img_in.device)
            with torch.no_grad():  # the eps-net is a constant of the guidance
                e_t = model_fn(img_in, tb)[..., : img_in.shape[-1]]
            pred_x0 = (img_in - torch.sqrt(1 - a_t) * e_t) / torch.sqrt(a_t)
            dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma_t**2, min=0.0)) * e_t
            out = torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma_t * noise
            diff = y0 - operator.H_img(decode_fn(pred_x0))
            return torch.linalg.vector_norm(diff), (out, pred_x0)

        _, (out, pred_x0), norm_grad = grad_of(guided, img)
        img = out - norm_grad * (a_t * 0.5)

        stage = travel_stage(index, total, cfg)
        if stage == "pixel":
            x_pix = adamw_opt(lambda x: torch.mean((y0 - operator.H_img(x)) ** 2),
                              decode_fn(pred_x0), cfg.pixel_opt_iters, cfg.pixel_opt_lr)
            img = stochastic_resample(encode_fn(x_pix), img, a_prev,
                                      sigma_of(a_prev, a_t), tnoise)
        elif stage == "latent":
            z = adamw_opt(data_loss, pred_x0, cfg.latent_opt_iters, cfg.latent_opt_lr)
            img = stochastic_resample(z, img, a_prev, sigma_of(a_prev, a_t), tnoise)

    return adamw_opt(data_loss, img, cfg.latent_opt_iters, cfg.latent_opt_lr)
