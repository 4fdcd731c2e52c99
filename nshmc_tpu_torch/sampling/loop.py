"""The iterative sampling loop over the DDIM ladder (port of
nshmc_tpu/sampling/loop.py): one Python loop over `seq.reversed_pairs()`
calling the algorithm's step, as sampling/ddim.py runs its ladder.

Each step's randomness is `algo.draw(generator, xt)`, or the next entry of
`draws` where the caller gives them (a test replaying the JAX key chain,
`key, sub = split(key)` per step). The loop runs without autograd; an
algorithm that differentiates takes its gradient inside its step.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..algos.base import Algo, ModelFn
from ..schedules import DDIMSequence, DiffusionSchedule


@torch.no_grad()
def iterative_sampling(model_fn: ModelFn, schedule: DiffusionSchedule, seq: DDIMSequence,
                       algo: Algo, xt: torch.Tensor, y0: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Iterable[tuple]] = None) -> torch.Tensor:
    """Run the algorithm over reversed(seq); returns the final x (the x0
    prediction after the terminal t = -1 step)."""
    draws = iter(draws) if draws is not None else None
    state = algo.init_state(xt)
    for t, t_next in seq.reversed_pairs().tolist():
        step_draws = next(draws) if draws is not None else algo.draw(generator, xt)
        xt, state = algo.step(model_fn, xt, state, t, schedule.alpha_bar(t),
                              schedule.alpha_bar(t_next), y0, step_draws)
    return xt
