"""MCMC convergence diagnostics: effective sample size and split-R-hat (a
copy of nshmc_tpu/utils/diagnostics.py, which is numpy only).

The Vehtari et al. 2021 recipe: split each chain in half, pool the split
chains for the between- and within-chain variances, and truncate the
autocorrelation sum with Geyer's initial monotone sequence.

Every function takes draws shaped (n_chains, n_draws, ...), as a numpy
array or a tensor, and reduces over trailing dims independently
(per-parameter diagnostics) in float64 numpy on the host: they run on kept
samples after the sampler, not inside it.
"""
from __future__ import annotations

import numpy as np


def _as_numpy(draws) -> np.ndarray:
    if hasattr(draws, "detach"):  # a torch tensor
        draws = draws.detach().cpu().numpy()
    return np.asarray(draws)


def _split_chains(draws: np.ndarray) -> np.ndarray:
    """(m, n, ...) -> (2m, n//2, ...): split each chain in half."""
    half = draws.shape[1] // 2
    return np.concatenate([draws[:, :half], draws[:, half: 2 * half]], axis=0)


def split_rhat(draws) -> np.ndarray:
    """Split-R-hat per parameter. draws: (n_chains, n_draws, *param_shape);
    returns (*param_shape,). Needs n_draws >= 4. R-hat ~ 1.0 at
    convergence; > 1.01 is suspect (Vehtari et al. 2021)."""
    draws = np.asarray(_as_numpy(draws), np.float64)
    squeeze = draws.ndim == 2
    if squeeze:
        draws = draws[..., None]
    s = _split_chains(draws)
    n = s.shape[1]
    chain_mean = s.mean(axis=1)
    chain_var = s.var(axis=1, ddof=1)
    between = n * chain_mean.var(axis=0, ddof=1)
    within = chain_var.mean(axis=0)
    var_plus = (n - 1) / n * within + between / n
    # Frozen chains (every draw of a chain the same: an all-reject run) give
    # within -> 0: R-hat is inf when they froze at different values (no
    # mixing), and 1.0 when the parameter is constant over every chain (no
    # information, no evidence of non-convergence).
    constant = var_plus <= 1e-300
    frozen = (within <= 1e-12 * var_plus) & ~constant
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / within)
    rhat = np.where(constant, 1.0, np.where(frozen, np.inf, rhat))
    return rhat[..., 0] if squeeze else rhat


def _autocov(x: np.ndarray) -> np.ndarray:
    """Autocovariance per lag via FFT. x: (n,); returns (n,)."""
    n = len(x)
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def ess(draws) -> np.ndarray:
    """Bulk effective sample size per parameter with Geyer's initial
    monotone sequence estimator over split chains. draws: (n_chains,
    n_draws, *param_shape); returns (*param_shape,)."""
    draws = np.asarray(_as_numpy(draws), np.float64)
    squeeze = draws.ndim == 2
    if squeeze:
        draws = draws[..., None]
    shape = draws.shape[2:]
    flat = draws.reshape(draws.shape[0], draws.shape[1], -1)
    out = np.array([_ess_1d(flat[:, :, p]) for p in range(flat.shape[-1])]).reshape(shape)
    return out[..., 0] if squeeze else out


def _ess_1d(draws: np.ndarray) -> float:
    s = _split_chains(draws[..., None])[..., 0]
    m, n = s.shape
    if n < 4:
        return float("nan")
    within = s.var(axis=1, ddof=1).mean()
    var_plus = (n - 1) / n * within + n * s.mean(axis=1).var(ddof=1) / n
    if var_plus <= 0 or not np.isfinite(var_plus):
        return float("nan")
    acov = np.stack([_autocov(s[i]) for i in range(m)]).mean(axis=0)
    rho = 1.0 - (within - acov) / var_plus  # rho[0] ~ 1
    # Geyer: pairs of lags (2t, 2t+1) from (rho_0, rho_1), summed while
    # positive and kept monotone decreasing; tau = -1 + 2 sum P_t
    tau = -1.0
    prev_pair = np.inf
    t = 0
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev_pair)
        prev_pair = pair
        tau += 2.0 * pair
        t += 2
    return float(m * n / max(tau, 1e-12))


def summarize_chains(draws, max_params: int = 64) -> dict:
    """Diagnostics of kept HMC samples. draws: (n_chains, n_draws, *shape).
    For image-sized states the per-parameter diagnostics cover a fixed
    subsample of `max_params` coordinates, plus two scalar functionals of
    each draw (its mean and its second moment)."""
    draws = _as_numpy(draws)
    nc, nd = draws.shape[:2]
    flat = draws.reshape(nc, nd, -1)
    dim = flat.shape[-1]
    idx = np.linspace(0, dim - 1, min(max_params, dim)).astype(int)
    sub = flat[:, :, idx]
    r = split_rhat(sub)
    e = ess(sub)
    scalar_mean = flat.mean(axis=-1)
    scalar_m2 = (flat ** 2).mean(axis=-1)
    # a chain whose draws are all the same (an all-reject run) carries no
    # within-chain information: flagged, rather than left to an inf R-hat
    chain_dead = (flat.astype(np.float64).var(axis=1) <= 1e-300).all(axis=-1)
    n_frozen_params = int(np.isinf(r).sum())
    return {
        "n_chains": int(nc),
        "n_draws": int(nd),
        "rhat_max": float(np.nanmax(r)),
        "rhat_median": float(np.nanmedian(r)),
        "ess_min": float(np.nanmin(e)),
        "ess_median": float(np.nanmedian(e)),
        "rhat_scalar_mean": float(split_rhat(scalar_mean[..., None])[0]),
        "ess_scalar_mean": float(ess(scalar_mean[..., None])[0]),
        "rhat_scalar_m2": float(split_rhat(scalar_m2[..., None])[0]),
        "ess_scalar_m2": float(ess(scalar_m2[..., None])[0]),
        "n_frozen_chains": int(chain_dead.sum()),
        "n_frozen_params": n_frozen_params,
        "degenerate": bool(chain_dead.any() or n_frozen_params > 0),
    }


def format_summary(diag: dict) -> str:
    """One line for the CLI, with an explicit message for frozen chains."""
    if diag.get("degenerate"):
        return (f"rhat_max=inf ({diag['n_frozen_chains']}/{diag['n_chains']} "
                f"chains frozen, {diag['n_frozen_params']} degenerate params "
                "- all-reject or stuck chains; R-hat undefined)")
    return (f"rhat_max={diag['rhat_max']:.3f} "
            f"ess_min={diag['ess_min']:.1f}")
