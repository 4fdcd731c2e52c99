"""DMPlug: direct optimization of the initial noise x_T (port of
nshmc_tpu/solvers/dmplug.py).

Both solvers minimize ||y0 - H(decode(x_T))||^2 through the differentiable
DDIM decoder, the one noise-space HMC samples through, so they run the same
kernels:
  dmplug_adam  - Adam (lr 1e-2) up to 10k steps, stopped early when the
                 variance of a 50-deep ring of decoded images has not
                 improved for `patience` steps;
  dmplug_lbfgs - L-BFGS with a backtracking line search, 300 x 20 steps at
                 most, with torch-LBFGS-style convergence exits.
Each writes out the optax update the JAX package runs (optax 0.2.6: `adam`,
`lbfgs` with `scale_by_backtracking_linesearch(store_grad=True)`), not
`torch.optim`, whose L-BFGS takes a different first step and line search.
The scalars of the line search stay float32 tensors, as optax keeps them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..hmc.engine import value_and_grad
from .adamw import adamw_step

LossAndDecode = Callable[[torch.Tensor], tuple]
# loss_and_decode(x) -> (scalar loss, decoded image batch); differentiable in x


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


LBFGS_MEMORY = 10  # optax.lbfgs's default memory_size


@dataclasses.dataclass(frozen=True)
class DMPlugAdamConfig:
    lr: float = 1e-2
    max_steps: int = 10000
    buffer_size: int = 50  # the sliding window of decoded images
    patience: int = 300


def dmplug_adam(loss_and_decode: LossAndDecode, x0: torch.Tensor,
                cfg: DMPlugAdamConfig = DMPlugAdamConfig(),
                progress: Optional[Callable[[int, float], None]] = None):
    """Adam on x_T (nshmc_tpu/solvers/dmplug.py:41-80), optax's update
    m_hat / (sqrt(v_hat) + eps). After each step the decoded image enters a
    ring of `buffer_size`; once the ring is full, the run stops when the
    ring's variance (the mean over the ring of the squared distance to its
    mean) has not improved for `patience` steps. Returns (x_T, decoded): x_T
    after the last update and the decoded image of the last gradient
    evaluation, the iterate before that update, as the JAX solver returns.
    `progress(step, loss)` runs after each step."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    numel = x.numel()
    ring = torch.zeros((cfg.buffer_size, numel), dtype=torch.float32, device=x.device)
    best_var, wait, decoded = math.inf, 0, None
    for step in range(cfg.max_steps):
        loss, decoded, g = value_and_grad(loss_and_decode, x)
        x, mu, nu = adamw_step(x, g, mu, nu, step, cfg.lr)
        if progress is not None:
            progress(step + 1, float(loss))

        ring[step % cfg.buffer_size] = decoded.reshape(-1)[:numel]
        if step + 1 >= cfg.buffer_size:
            var = float(torch.mean(torch.sum((ring - ring.mean(dim=0)) ** 2, dim=1)))
            if var < best_var:
                best_var, wait = var, 0
            else:
                wait += 1
            if wait >= cfg.patience:
                break
    if decoded is None:  # no step at all: the decoded image of x0
        with torch.no_grad():
            decoded = loss_and_decode(x0)[1]
    return x, decoded


def dmplug_lbfgs(loss_and_decode: LossAndDecode, x0: torch.Tensor, epochs: int = 300,
                 max_inner: int = 20, tol_grad: float = 1e-7, tol_change: float = 1e-9,
                 max_backtracking: int = 5, chunk: int = 20,
                 progress: Optional[Callable[[int, float], None]] = None):
    """L-BFGS on x_T (nshmc_tpu/solvers/dmplug.py:83-149): optax's
    `lbfgs` (memory 10; the initial inverse Hessian gamma I with
    gamma = s'y / y'y, and min(1, 1/||g||) on the first step) under its
    backtracking line search (start at min(1.5 x the previous rate, 1),
    shrink by 0.8 until f(x + a d) <= f(x) + 1e-4 a d'g, at most
    `max_backtracking` + 1 rates, a zero step if every trial value was not
    finite), the gradient at the accepted point reused by the next step.
    The steps run in chunks of `chunk` with the exits max|g| <= tol_grad or
    |loss change| <= tol_change checked after each step, and the budget
    epochs * max_inner checked between chunks; `progress(steps, loss)` runs
    after each chunk. Returns (x_T, decoded image of x_T).

    Decoder cost: each trial rate is one forward of the loss, its autograd
    graph kept until the line search decides; the accepted (or last) trial
    adds one backward, and a step whose stored value is not finite (the
    first step, or after a zero step) one forward and backward at x. That
    is what optax's linearize at each trial and transpose at the accepted
    one cost; the rejected trials' graphs are dropped unused."""
    x = x0.detach().clone()
    dev = x.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    s_mem = torch.zeros((LBFGS_MEMORY,) + x.shape, dtype=x.dtype, device=dev)
    y_mem = torch.zeros_like(s_mem)
    rho = torch.zeros(LBFGS_MEMORY, dtype=torch.float32, device=dev)
    prev_x = prev_g = None
    count = 0
    rate = f32(1.0)  # the line search's last accepted rate
    value, grad = f32(math.inf), None  # the stored value and gradient at x

    def step_once():
        nonlocal x, prev_x, prev_g, count, rate, value, grad
        if not bool(torch.isfinite(value)):
            value, _, grad = value_and_grad(loss_and_decode, x)
        loss, g = value, grad
        # the memory of (s, y, 1 / s'y) and the initial scale gamma
        mem_idx, prev_idx = count % LBFGS_MEMORY, (count - 1) % LBFGS_MEMORY
        if count > 0:
            s, y = x - prev_x, g - prev_g
            sy = _vdot(y, s)
            s_mem[prev_idx], y_mem[prev_idx] = s, y
            rho[prev_idx] = torch.where(sy == 0.0, f32(0.0), 1.0 / sy)
            yy = _vdot(y, y)
            gamma = torch.where(yy > 0.0, sy / yy, f32(1.0))
        else:
            gamma = torch.clamp(1.0 / torch.sqrt(_vdot(g, g)), max=1.0)
        # two-loop recursion, newest pair first
        order = [(mem_idx + j) % LBFGS_MEMORY for j in range(LBFGS_MEMORY)]
        vec, alphas = g, {}
        for idx in reversed(order):
            alphas[idx] = rho[idx] * _vdot(s_mem[idx], vec)
            vec = vec + (-alphas[idx]) * y_mem[idx]
        vec = gamma * vec
        for idx in order:
            beta = rho[idx] * _vdot(y_mem[idx], vec)
            vec = vec + (alphas[idx] - beta) * s_mem[idx]
        prev_x, prev_g, count = x, g, count + 1
        direction = -vec

        # backtracking line search (Armijo) along `direction`
        slope = _vdot(direction, g)
        lr = torch.clamp(1.5 * rate, max=1.0)
        new_value, new_grad, error = loss, None, f32(math.inf)
        for it in range(max_backtracking + 1):
            if it > 0:
                lr = 0.8 * lr
            trial = (x + lr * direction).detach().requires_grad_(True)
            with torch.enable_grad():
                new_value = loss_and_decode(trial)[0]
                error = new_value.detach() - 1.0 * value - lr * 1e-4 * slope
                error = torch.clamp(torch.where(torch.isnan(error), f32(math.inf), error),
                                    min=0.0)
                if bool(error <= 0.0) or it == max_backtracking:
                    (new_grad,) = torch.autograd.grad(new_value, trial)
            new_value = new_value.detach()
            if bool(error <= 0.0):
                break
        rate = torch.where(torch.isinf(error), f32(0.0), lr)
        x = x + rate * direction
        value, grad = new_value, new_grad
        return loss, g

    steps, prev_loss = 0, f32(math.inf)
    while steps < epochs * max_inner:
        done = 0
        converged = False
        while not converged and done < chunk:
            loss, g = step_once()
            converged = bool((torch.max(torch.abs(g)) <= tol_grad)
                             | (torch.abs(prev_loss - loss) <= tol_change))
            prev_loss = loss
            done += 1
        steps += done
        if progress is not None:
            progress(steps, float(prev_loss))
        if converged:
            break
    with torch.no_grad():
        decoded = loss_and_decode(x)[1]
    return x, decoded
