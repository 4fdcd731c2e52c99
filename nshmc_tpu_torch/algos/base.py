"""Posterior-sampling algorithm interface (port of nshmc_tpu/algos/base.py).

Each algorithm is a dataclass over its operator and float hyperparameters
with a `cal_x0 / map_back` step pair that `sampling/loop.py` calls once per
DDIM step. Cross-step state (RED-diff's x0_t_last) is an explicit tuple, as
the JAX `init_state` has it. torch's generator is not JAX's threefry, so the
randomness of a step comes in as `draws`: the tuple `draw(generator, xt)`
makes, in a fixed order and at the JAX package's shapes, or the same draws
replayed from the JAX key chain by a test.

`t` is a Python int, `at` and `at_next` 0-dim float32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..operators.base import Operator, flatten_image, unflatten_image

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def predict_eps(model_fn: ModelFn, xt: torch.Tensor, t) -> torch.Tensor:
    """eps prediction with the learn_sigma slice (nshmc_tpu/algos/base.py:26-29)."""
    tb = torch.full((xt.shape[0],), float(t), dtype=torch.float32, device=xt.device)
    return model_fn(xt, tb)[..., : xt.shape[-1]]


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as JAX computes it, min(max(x, lo), hi): at an exact tie its
    gradient is halved, where torch.clamp passes it whole."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def predict_x0(xt, et, at):
    """x0_t = (xt - eps*sqrt(1-at)) / sqrt(at), clipped to [-1, 1]."""
    return clip((xt - et * torch.sqrt(1.0 - at)) / torch.sqrt(at), -1.0, 1.0)


def randn(shape, generator: Optional[torch.Generator], like: torch.Tensor) -> torch.Tensor:
    """A float32 N(0, I) draw of `shape` on `like`'s device."""
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=like.device)


def grad_of(loss_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, Any]], x: torch.Tensor):
    """(loss, aux, d loss / d x) of loss_fn(x) -> (scalar, aux), as
    jax.value_and_grad(has_aux=True); loss and aux detached."""
    leaf = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn(leaf)
        (g,) = torch.autograd.grad(loss, leaf)
    aux = tuple(a.detach() for a in aux) if isinstance(aux, tuple) else aux
    return loss.detach(), aux, g


@dataclasses.dataclass(frozen=True)
class Algo:
    """Step-pair interface (nshmc_tpu/algos/base.py:38-75). Algorithms
    without cross-step state keep `()`."""

    operator: Operator
    sigma_0: float = 0.1
    noise: str = "ddpm"

    def init_state(self, xt: torch.Tensor) -> Any:
        return ()

    def draw(self, generator: Optional[torch.Generator], xt: torch.Tensor) -> tuple:
        """One step's draws: a standard normal of x0's shape."""
        return (randn(xt.shape, generator, xt),)

    def cal_x0(self, model_fn: ModelFn, xt, state, t, at, at_next, y0, draws):
        """Returns (x0_t, add_up, new_state)."""
        raise NotImplementedError

    def map_back(self, x0_t, y0, add_up, at_next, at) -> torch.Tensor:
        """The DDIM recombination."""
        return torch.sqrt(at_next) * x0_t + add_up

    def step(self, model_fn: ModelFn, xt, state, t, at, at_next, y0, draws):
        """One sampler step; ReSample overrides it, its branch spanning both
        halves."""
        x0, add_up, state = self.cal_x0(model_fn, xt, state, t, at, at_next, y0, draws)
        return self.map_back(x0, y0, add_up, at_next, at), state

    # the spectral helpers: image (B, H, W, C) <-> flat (B, D) channel-first
    def _flat(self, img):
        return flatten_image(img)

    def _img(self, vec, like):
        return unflatten_image(vec, like.shape[-1], like.shape[1])


@dataclasses.dataclass(frozen=True)
class Unconditional(Algo):
    """The plain DDIM eta=0 step, which HMC and DMPlug decode through."""

    def draw(self, generator, xt):
        return ()

    def cal_x0(self, model_fn, xt, state, t, at, at_next, y0, draws):
        et = predict_eps(model_fn, xt, t)
        x0 = predict_x0(xt, et, at)
        return x0, torch.sqrt(1.0 - at_next) * et, state
