"""The JAX engines' draws, replayed into the port's samplers.

A JAX chain carries its PRNG key: each attempt splits it into the next key
and the proposal's key, which splits into the momentum's and the accept
uniform's. A finished chain keeps its key (the drivers' `where(done, old,
new)` covers the key field), so it consumes no draw; `chain_draws` therefore
indexes each chain's draws by that chain's own attempt count."""
import jax
import jax.numpy as jnp
import numpy as np
import torch


def replay_draws(key, n_chains, shape, n_attempts):
    """The draws of `init_chains(key, cfg, n_chains, shape)` (and of
    init_conditioned_chains and init_latent_chains, which split alike): x_T
    per chain and, per attempt, the UNIT-normal momentum p0 (the engines
    scale it by sqrt(mass)) and the uniform u of each chain.
    Returns x (N, ...), p0 (A, N, ...), u (A, N)."""
    xs, p0s, us = [], [], []
    for k in jax.random.split(key, n_chains):
        kx, k = jax.random.split(k)
        xs.append(np.asarray(jax.random.normal(kx, shape, jnp.float32)))
        ps, uu = [], []
        for _ in range(n_attempts):
            k, k_prop = jax.random.split(k)
            k_mom, k_acc = jax.random.split(k_prop)
            ps.append(np.asarray(jax.random.normal(k_mom, shape, jnp.float32)))
            uu.append(float(jax.random.uniform(k_acc)))
        p0s.append(ps)
        us.append(uu)
    return (np.stack(xs), np.stack(p0s, axis=1).astype(np.float32),
            np.asarray(us, np.float32).T)


def chain_draws(p0, u, start=None):
    """Per round, the (p0, u) tensors of every chain: chain c's k-th round
    from `start[c]` (its attempt count when the run starts, 0 by default)
    takes its draw number start[c] + k, so a chain that sat out rounds
    picks up where its own key stands. Past the replayed draws the last is
    repeated (only frozen chains, whose draws are unused, get there)."""
    n_att, n = u.shape
    start = np.zeros(n, np.int64) if start is None else np.asarray(start, np.int64)
    cols = np.arange(n)
    k = 0
    while True:
        idx = np.minimum(start + k, n_att - 1)
        yield torch.from_numpy(p0[idx, cols]), torch.from_numpy(u[idx, cols])
        k += 1
