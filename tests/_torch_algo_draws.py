"""The JAX baseline samplers' draws, replayed into the port's.

Each sampler of the JAX package threads one PRNG key; the port takes each
step's draws as a tuple in the order its `draw` method makes them. These
helpers walk the JAX key schedule and return, per step, that tuple as
float32 CPU tensors:
  - iterative_sampling: `key, sub = split(key)` per step
    (nshmc_tpu/sampling/loop.py:31), then the algorithm's draws from `sub`:
    one normal of x0's shape (DDNM noiseless, DPS, PiGDM, DMPS, RED-diff,
    DiffPIR) or of (B, d) (DDNM noisy); DDRM `split(sub, 3)` into (B, d),
    (B, d), (B, rank) (spectral.py:203); ReSample `split(sub)` into the DPS
    noise and the resample noise (resample.py:89);
  - run_daps: `key, k_lan, k_noise = split(key, 3)` per step, the Langevin
    noises from `split(k_lan, langevin_steps)` (optim_based.py:139, :121);
  - resample_original_sample: `key, k_noise, k_travel = split(key, 3)` per
    step (sampling/resample_original.py:155)."""
import jax
import numpy as np
import torch


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, np.float32)))


def loop_draws(key, n_steps, shapes, split=1):
    """iterative_sampling's draws: per step `sub`, then the normals of
    `shapes`, from `sub` itself (split=1) or from `split(sub, split)`."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        keys = [sub] if split == 1 else list(jax.random.split(sub, split))
        out.append(tuple(_normal(k, s) for k, s in zip(keys, shapes)))
    return out


def daps_draws(key, n_steps, shape, langevin_steps):
    out = []
    for _ in range(n_steps):
        key, k_lan, k_noise = jax.random.split(key, 3)
        lan = torch.stack([_normal(k, shape) for k in jax.random.split(k_lan, langevin_steps)])
        out.append((lan, _normal(k_noise, shape)))
    return out


def resample_original_draws(key, n_steps, shape):
    out = []
    for _ in range(n_steps):
        key, k_noise, k_travel = jax.random.split(key, 3)
        out.append((_normal(k_noise, shape), _normal(k_travel, shape)))
    return out


def algo_draws(algo, key, n_steps, shape):
    """The per-step draws of the port's `algo` (an nshmc_tpu_torch.algos
    instance) under iterative_sampling with the JAX key `key`; `shape` is
    x_T's (B, H, W, C)."""
    name = type(algo).__name__
    if name == "Unconditional":
        return [()] * n_steps
    b, d = shape[0], int(np.prod(shape[1:]))
    if name == "DDRM":
        rank = algo.operator.singulars().shape[0]
        return loop_draws(key, n_steps, [(b, d), (b, d), (b, rank)], split=3)
    if name == "ReSample":
        return loop_draws(key, n_steps, [shape, shape], split=2)
    if name == "DDNM" and algo.sigma_0 != 0:
        return loop_draws(key, n_steps, [(b, d)])
    return loop_draws(key, n_steps, [shape])
