"""Beta schedules and the deterministic few-step DDIM decoder (eta = 0), as
in DDIM (Song et al., 2021) and the noise-space HMC paper's decoder: the
ladder T/(n+1) * (n, ..., 1) -> x0, each step
    x0_t = clip((x_t - eps sqrt(1 - a_t)) / sqrt(a_t), -1, 1)
    x_next = sqrt(a_next) x0_t + sqrt(1 - a_next) eps
with a_{-1} = 1, so the last step returns the clipped x0 prediction."""
from __future__ import annotations

import numpy as np
import torch


def alphas_cumprod(schedule: str, start: float, end: float, steps: int) -> np.ndarray:
    """'linear' (ADM) or 'quad' (the LDM's 'linear', a linspace in sqrt space)."""
    if schedule == "linear":
        betas = np.linspace(start, end, steps, dtype=np.float64)
    elif schedule == "quad":
        betas = np.linspace(start ** 0.5, end ** 0.5, steps, dtype=np.float64) ** 2
    else:
        raise ValueError(f"beta schedule {schedule!r}")
    return np.cumprod(1.0 - betas)


def ladder(num_timesteps: int, steps: int):
    """[(t, t_next), ...] in sampling order: 750 -> 500 -> 250 -> -1 for 1000, 3."""
    skip = num_timesteps // (steps + 1)
    seq = list(range(skip, num_timesteps, skip))
    return list(zip(reversed(seq), reversed([-1] + seq[:-1])))


def decode(eps_fn, ac: np.ndarray, pairs, x: torch.Tensor, eps_grad: bool = True) -> torch.Tensor:
    """Run the ladder from x (NHWC). eps_fn(x, t (B,)) -> eps with at least
    x's channels; with eps_grad False the eps prediction is a constant of
    the graph (the LDM's no-grad apply_model)."""
    abar = lambda t: 1.0 if t < 0 else float(ac[t])
    c = x.shape[-1]
    for t, t_next in pairs:
        tb = torch.full((x.shape[0],), float(t), device=x.device)
        if eps_grad:
            e = eps_fn(x, tb)[..., :c]
        else:
            with torch.no_grad():
                e = eps_fn(x.detach(), tb)[..., :c]
        at, an = abar(t), abar(t_next)
        x0 = torch.clamp((x - e * (1.0 - at) ** 0.5) / at ** 0.5, -1.0, 1.0)
        x = an ** 0.5 * x0 + (1.0 - an) ** 0.5 * e
    return x
