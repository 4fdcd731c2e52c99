"""Adam and AdamW as optax 0.2.6 computes them (`optax.adam`, `optax.adamw`),
written out: DMPlug's Adam (solvers/dmplug.py) and both ReSamples' inner
solves (algos/resample.py, sampling/resample_original.py) step through
`adamw_step`.

optax's update, in order: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
u = mu_hat / (sqrt(nu_hat) + eps) with the bias corrections in float32,
then u + weight_decay * x (adamw only), then x + (-lr) u. torch.optim.AdamW
decays x before the Adam step (x (1 - lr wd) - lr u), another rounding.
"""
from __future__ import annotations

from typing import Callable

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's and adamw's defaults
ADAMW_WEIGHT_DECAY = 0.01  # torch.optim.AdamW's default, which the reference's solves use


def adamw_step(x: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
               step: int, lr: float, weight_decay: float = 0.0):
    """Update number `step` (0-based) at x with gradient g; returns
    (x, mu, nu). With weight_decay 0 it is optax.adam's update."""
    mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * g**2 + ADAM_B2 * nu
    b1 = torch.tensor(ADAM_B1, dtype=torch.float32, device=x.device)
    b2 = torch.tensor(ADAM_B2, dtype=torch.float32, device=x.device)
    u = (mu / (1 - b1 ** (step + 1))) / (torch.sqrt(nu / (1 - b2 ** (step + 1))) + ADAM_EPS)
    if weight_decay:
        u = u + weight_decay * x
    return x + (-lr) * u, mu, nu


def adamw_opt(loss_fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, iters: int,
              lr: float, weight_decay: float = ADAMW_WEIGHT_DECAY) -> torch.Tensor:
    """`iters` AdamW steps on the scalar loss_fn from x0 (the JAX package's
    `fori_loop` over `optax.adamw(lr, weight_decay=0.01)`); returns the last
    iterate, detached."""
    x = x0.detach()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    for step in range(iters):
        leaf = x.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
        x, mu, nu = adamw_step(x, g, mu, nu, step, lr, weight_decay)
    return x.detach()
