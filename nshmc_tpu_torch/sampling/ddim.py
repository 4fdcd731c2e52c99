"""Differentiable few-step DDIM decoder (port of nshmc_tpu/sampling/ddim.py).

The ladder x_T -> x_0 is one Python loop over the (t, t_next) pairs; the
JAX package's scan / unroll / chunked-unroll forms are compile forms with
identical numerics and have no counterpart here. Autograd through the loop
is the HMC gradient oracle; activation memory is bounded by the U-Net's own
checkpointing (models/unet.py).

`model_fn(x_nhwc, t) -> eps` may return 6 channels (learn_sigma); the
first `x.shape[-1]` are used.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..schedules import DDIMSequence, DiffusionSchedule
from ..utils import profiling

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_step(model_fn: ModelFn, schedule: DiffusionSchedule, xt: torch.Tensor,
              t: int, t_next: int):
    """One deterministic DDIM (eta=0) step: returns (xt_next, x0_t).

    x0_t = clip((xt - eps*sqrt(1-at)) / sqrt(at), -1, 1)
    xt_next = sqrt(at_next)*x0_t + sqrt(1-at_next)*eps
    """
    with profiling.span("ddim.step"):
        c = xt.shape[-1]
        at = schedule.alpha_bar(t)
        at_next = schedule.alpha_bar(t_next)
        tb = torch.full((xt.shape[0],), float(t), dtype=torch.float32, device=xt.device)
        with profiling.span("ddim.model"):
            et = model_fn(xt, tb)[..., :c]
        x0_t = (xt - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        x0_t = torch.clamp(x0_t, -1.0, 1.0)
        xt_next = torch.sqrt(at_next) * x0_t + torch.sqrt(1.0 - at_next) * et
    return xt_next, x0_t


def ddim_decode(model_fn: ModelFn, schedule: DiffusionSchedule, seq: DDIMSequence,
                x: torch.Tensor) -> torch.Tensor:
    """Run the whole ladder. The last step maps to alpha_bar(-1) = 1, so the
    result is the final, already clipped x0 prediction."""
    xt = x
    for t, t_next in seq.reversed_pairs().tolist():
        xt, _ = ddim_step(model_fn, schedule, xt, t, t_next)
    return xt


def make_decoder(model_fn: ModelFn, schedule: DiffusionSchedule, seq: DDIMSequence):
    """Close over model and schedule: decode(x_T) -> x_0 (NHWC batch)."""

    def decode(x):
        return ddim_decode(model_fn, schedule, seq, x)

    return decode
