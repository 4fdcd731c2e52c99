"""Schedule-free AdamW (port of nshmc_tpu/solvers/sf_adamw.py).

The gradient is evaluated at the averaged iterate x (DiffPIR's usage), then

    y   = x + (1-beta1) (z - x)          # extrapolate
    v   = beta2 v + (1-beta2) g^2
    gn  = g / (sqrt(v / bc2) + eps) + decay * y
    z   = z - lr * gn
    x   = x + c_{k+1} (z - x),  c_{k+1} = w_{k+1} / sum w

with w_k = k^r * lr_max^weight_lr_power. `params` is a tensor or a tuple of
tensors; the step count `k` is an int32 tensor and `weight_sum`, `lr_max`
float32 tensors, as the JAX state keeps them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SFAdamWState(NamedTuple):
    z: object
    exp_avg_sq: object
    k: torch.Tensor
    weight_sum: torch.Tensor
    lr_max: torch.Tensor


def _map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


def _first(tree) -> torch.Tensor:
    return tree[0] if isinstance(tree, tuple) else tree


def sf_adamw_init(params) -> SFAdamWState:
    dev = _first(params).device
    return SFAdamWState(
        z=_map(lambda p: p.detach().clone(), params),
        exp_avg_sq=_map(torch.zeros_like, params),
        k=torch.zeros((), dtype=torch.int32, device=dev),
        weight_sum=torch.zeros((), dtype=torch.float32, device=dev),
        lr_max=torch.zeros((), dtype=torch.float32, device=dev),
    )


def sf_adamw_step(params, grads, state: SFAdamWState, lr: float = 0.0025, beta1: float = 0.9,
                  beta2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                  warmup_steps: int = 0, r: float = 0.0, weight_lr_power: float = 2.0):
    """One update (nshmc_tpu/solvers/sf_adamw.py:44-91); returns
    (new_params, new_state)."""
    kf = state.k.to(torch.float32)
    sched = torch.where(state.k < warmup_steps, (kf + 1) / max(warmup_steps, 1),
                        torch.ones_like(kf))
    lr_t = lr * sched
    lr_max = torch.maximum(lr_t, state.lr_max)
    weight = (kf + 1.0) ** r * lr_max**weight_lr_power
    weight_sum = state.weight_sum + weight
    ckp1 = torch.where(weight_sum > 0, weight / weight_sum, torch.zeros_like(weight))
    bc2 = 1.0 - beta2 ** (kf + 1.0)

    def upd(x, g, z, v):
        y = x + (1.0 - beta1) * (z - x)
        v = beta2 * v + (1.0 - beta2) * g**2
        gn = g / (torch.sqrt(v / bc2) + eps)
        if weight_decay != 0.0:
            gn = gn + weight_decay * y
        z = z - lr_t * gn
        return x + ckp1 * (z - x), z, v

    out = _map(upd, params, grads, state.z, state.exp_avg_sq)
    if isinstance(params, tuple):
        x_new, z_new, v_new = (tuple(o[i] for o in out) for i in range(3))
    else:
        x_new, z_new, v_new = out
    return x_new, SFAdamWState(z=z_new, exp_avg_sq=v_new, k=state.k + 1,
                               weight_sum=weight_sum, lr_max=lr_max)
