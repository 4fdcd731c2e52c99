"""nshmc_tpu_torch's Walsh-Hadamard compressive sensing (operators/cs.py)
against nshmc_tpu.operators.cs on the CPU. Tolerances:
tests/_torch_operator_parity.py (permutations exact, the transform and
every map 1e-5 max|ref|, input gradients 1e-4 max|ref|)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import operators as jax_ops
from nshmc_tpu_torch import operators
from _torch_operator_parity import EXACT, PRODUCT, check_svd_operator, close

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1, 2, 8, 256, 1024])
def test_fwht_matches_jax_and_is_self_inverse(n):
    a = np.random.default_rng(n).standard_normal((2, 3, n)).astype(np.float32)
    scale = 1.0 / np.sqrt(n)
    ours = operators.fwht(torch.from_numpy(a), scale)
    close(ours, jax_ops.fwht(jnp.asarray(a), scale), PRODUCT, "fwht")
    close(operators.fwht(ours, scale), a, PRODUCT, "fwht twice")


def test_fwht_rejects_other_lengths():
    with pytest.raises(ValueError, match="power of 2"):
        operators.fwht(torch.zeros(2, 12), 1.0)


@pytest.mark.parametrize("deg,d", [("cs2", 16), ("cs4", 16), ("cs2", 32), ("cs8", 32)])
def test_cs_maps_match_jax(deg, d):
    ours = operators.build_operator(deg, 3, d, np.random.default_rng(d), device="cpu")
    ref = jax_ops.build_operator(deg, 3, d, np.random.default_rng(d))
    assert type(ours).__name__ == type(ref).__name__ == "WalshHadamardCS"
    close(ours.perm, ref.perm, EXACT, "perm")  # the same numpy draw
    close(ours.inv_perm, ref.inv_perm, EXACT, "inv_perm")
    assert ours.perm.dtype == torch.int64
    check_svd_operator(ours, ref, seed=d)


def test_cs_256_construction_matches_jax():
    ours = operators.build_operator("cs2", 3, 256, np.random.default_rng(0), device="cpu")
    ref = jax_ops.build_operator("cs2", 3, 256, np.random.default_rng(0))
    close(ours.perm, ref.perm, EXACT, "perm")
    x = np.random.default_rng(1).standard_normal((1, 3 * 256 * 256)).astype(np.float32)
    close(ours.H(torch.from_numpy(x)), ref.H(jnp.asarray(x)), PRODUCT, "H at 256^2")
