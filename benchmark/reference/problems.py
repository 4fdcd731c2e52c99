"""The reference side of every kind of cell: the energy, its decoded output
and image and its input gradient, over blocks of chains; the reference's own
leapfrog attempt and MH decision; and the lower precisions its controls run
in. Each kind of cell (the configuration's `system`) has a module beside
this one, reference/<system>.py, whose PROBLEM subclasses Problem with its
model, its decoder and the sampler's per-attempt step size and measurement
sigma, worked out from the traffic. Everything is float32 with TF32 off (or
a control's lower precision). Nothing here comes from the program."""
from __future__ import annotations

import importlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from .unet import Numerics


def load(system: str):
    """The Problem class of a kind of cell."""
    return importlib.import_module(f"{__package__}.{system}").PROBLEM


class Problem:
    """value_and_grad(x, y0) -> (loss (N,), decoded (N, ...), image (N, H, W,
    C), grad like x) of U(x) = ||y0 - H(image(x))||^2 per chain, over blocks
    of `chunk` chains, H the traffic's operator (reference/operators/).
    `loss_fn` is the same energy as the engine's loss callable, each block
    recomputed in the backward pass (the control, run in the program's
    place)."""

    chunk = 4

    def __init__(self, config: dict, traffic: dict, op, device):
        self.config, self.traffic, self.op, self.device = config, traffic, op, device
        self.models = []

    def numerics(self, nm: Numerics):
        for m in self.models:
            m.numerics = nm

    def decoded(self, x):
        """(decoded output, image) of positions x."""
        raise NotImplementedError

    def flips(self, dec_a: torch.Tensor, dec_b: torch.Tensor) -> list:
        """Per chain, the discrete choices two decoded outputs make apart."""
        raise NotImplementedError

    def attempt_params(self, decisions: torch.Tensor):
        """(eps, sigma_y) float64 (N,) of the attempt that follows the MH
        decisions (A, N) bool of the image's earlier attempts."""
        raise NotImplementedError

    def energy(self, x, y0):
        dec, img = self.decoded(x)
        r = y0[None] - self.op.H(img)
        return (r ** 2).sum(dim=1), dec, img

    def value_and_grad(self, x: torch.Tensor, y0: torch.Tensor):
        out = []
        for xc in x.split(self.chunk):
            xc = xc.detach().float().requires_grad_(True)
            with torch.enable_grad():
                loss, dec, img = self.energy(xc, y0)
                (g,) = torch.autograd.grad(loss.sum(), xc)
            out.append((loss.detach(), dec.detach(), img.detach(), g))
        return tuple(torch.cat(parts) for parts in zip(*out))

    def loss_fn(self, y0, tap=None):
        """The engine's loss callable; `tap(image)`, where given, sees each
        evaluation's image."""
        def fn(x):
            parts = [checkpoint(lambda xc: self.energy(xc, y0), xc, use_reentrant=False)
                     for xc in x.split(self.chunk)]
            loss, dec, img = (torch.cat(p) for p in zip(*parts))
            if tap is not None:
                tap(img)
            return loss, dec
        return fn


def _rounded(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to `dtype` with one scale for the tensor (its amax to the
    format's largest value), and back."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    s = top / amax
    return ((t.float() * s).to(dtype).float() / s).to(t.dtype)


class _FP8(torch.autograd.Function):
    """An fp8 operand: e4m3 forward; its gradient, where one flows, e5m2 (the
    usual fp8 recipe's formats)."""

    @staticmethod
    def forward(ctx, t):
        return _rounded(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _rounded(g, torch.float8_e5m2, 57344.0)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round a matmul's or convolution's operand as an fp8 kernel takes it."""
    return _FP8.apply(t)


def numerics(name: str) -> Numerics:
    """'float32'; the controls 'bfloat16' and 'fp8' (bfloat16 with each
    convolution's, linear layer's and attention product's operands in
    float8 e4m3 and the gradients flowing into them in e5m2)."""
    if name == "float32":
        return Numerics()
    if name == "bfloat16":
        return Numerics(torch.bfloat16)
    if name == "fp8":
        return Numerics(torch.bfloat16, fp8)
    raise ValueError(f"numerics {name!r}")


def _sq(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).pow(2).sum(1)


def leapfrog(problem: Problem, x_in, p0, u, eps, sigma_y, y0, n_leapfrog: int, m: float = 1.0):
    """The reference's own attempt from x_in: half step, n_leapfrog full
    steps with a gradient at each new position, half-step correction, then
    the MH decision (float64 arithmetic on its float32 energies). Returns
    (loss0, dec0, img0, grad0, x_1, x_L, log_ratio, accept): x_1 the first
    full step's position, x_L the last."""
    shape = (-1,) + (1,) * (x_in.dim() - 1)
    e, inv2s2 = eps.view(shape), (1.0 / (2.0 * sigma_y ** 2)).view(shape)
    x = x_in.double()
    p = p0.double() * math.sqrt(m)
    loss0, dec0, img0, g0 = problem.value_and_grad(x.float(), y0)
    h0 = 0.5 * _sq(x) + inv2s2.flatten() * loss0.double() + 0.5 * _sq(p) / m
    p = p - e / 2 * (x + inv2s2 * g0.double())
    loss, g = loss0, g0
    for step in range(n_leapfrog):
        x = x + e * p / m
        if step == 0:
            x_1 = x
        loss, _, _, g = problem.value_and_grad(x.float(), y0)
        p = p - e * (x + inv2s2 * g.double())
    p = p + e / 2 * (x + inv2s2 * g.double())
    h1 = 0.5 * _sq(x) + inv2s2.flatten() * loss.double() + 0.5 * _sq(p) / m
    log_ratio = -(h1 - h0)
    return loss0, dec0, img0, g0, x_1, x, log_ratio, mh_accept(log_ratio, u)


def mh_accept(log_ratio: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return (torch.log(u.double()) < torch.clamp(log_ratio, max=0.0)) & torch.isfinite(log_ratio)


def trajectory_log_ratio(xs, losses, grads, p0, eps, sigma_y, m: float = 1.0) -> torch.Tensor:
    """The MH log ratio -(H_L - H_0) of a recorded trajectory: positions xs
    (L + 1, N, ...), energies losses (L + 1, N) and gradients grads like xs,
    the momenta rebuilt from the unit-normal p0 by the same leapfrog
    updates (float64)."""
    shape = (-1,) + (1,) * (p0.dim() - 1)
    e, inv2s2 = eps.view(shape), (1.0 / (2.0 * sigma_y ** 2)).view(shape)
    force = lambda k: xs[k].double() + inv2s2 * grads[k].double()
    p = p0.double() * math.sqrt(m)
    h0 = 0.5 * _sq(xs[0].double()) + inv2s2.flatten() * losses[0].double() + 0.5 * _sq(p) / m
    p = p - e / 2 * force(0)
    for k in range(1, len(xs)):
        p = p - e * force(k)
    last = len(xs) - 1
    p = p + e / 2 * force(last)
    h1 = (0.5 * _sq(xs[last].double()) + inv2s2.flatten() * losses[last].double()
          + 0.5 * _sq(p) / m)
    return -(h1 - h0)
