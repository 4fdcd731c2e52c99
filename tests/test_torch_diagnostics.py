"""nshmc_tpu_torch.utils.diagnostics against nshmc_tpu.utils.diagnostics:
split-R-hat, ESS and the chain summary on random, frozen (all-reject) and
constant draws, as numpy arrays and as tensors, to 1e-12 (both float64
numpy on the host)."""
import numpy as np
import pytest
import torch

from nshmc_tpu.utils import diagnostics as jdiag
from nshmc_tpu_torch.utils import diagnostics


def _draws(kind):
    rng = np.random.default_rng(0)
    d = rng.standard_normal((4, 12, 3, 5)).astype(np.float32)
    d[1] += 0.5 * np.cumsum(rng.standard_normal((12, 3, 5)), axis=0).astype(np.float32)
    if kind == "frozen":  # two chains stuck at different values
        d[0] = d[0, :1]
        d[2] = d[2, :1] + 1.0
    elif kind == "constant":
        d[:] = 0.25
        d[:, :, 0, 0] = rng.standard_normal((4, 12))
    return d


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("kind", ["random", "frozen", "constant"])
def test_rhat_ess_summary_match_jax(kind):
    d = _draws(kind)
    for arg in (d, torch.from_numpy(d)):
        _close(diagnostics.split_rhat(arg), jdiag.split_rhat(d))
        _close(diagnostics.ess(arg), jdiag.ess(d))
        _close(diagnostics.split_rhat(arg[..., 0, 0]), jdiag.split_rhat(d[..., 0, 0]))
        _close(diagnostics.ess(arg[..., 0, 0]), jdiag.ess(d[..., 0, 0]))
        got, want = diagnostics.summarize_chains(arg), jdiag.summarize_chains(d)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
        assert diagnostics.format_summary(got) == jdiag.format_summary(want)
    if kind == "frozen":
        assert want["degenerate"] and want["n_frozen_chains"] == 2
    if kind == "constant":
        assert np.isfinite(diagnostics.split_rhat(d)).all()


def test_short_chains_give_nan_ess():
    d = np.random.default_rng(1).standard_normal((2, 5))
    _close(diagnostics.ess(d), jdiag.ess(d))
    assert np.isnan(diagnostics.ess(d))
