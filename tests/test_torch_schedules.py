"""nshmc_tpu_torch schedules against nshmc_tpu.schedules: bit-equal tables."""
import numpy as np
import pytest
import torch

from nshmc_tpu import schedules as jax_sched
from nshmc_tpu_torch import schedules

torch.set_num_threads(2)

SCHEDULES = ["quad", "linear", "sqrt_linear", "const", "jsd", "sigmoid", "cosine", "sqrt"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_beta_tables_bit_equal(name):
    a = schedules.make_betas(name, 1e-4, 2e-2, 1000)
    b = jax_sched.make_betas(name, 1e-4, 2e-2, 1000)
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)


def test_unknown_schedule_raises():
    with pytest.raises(NotImplementedError):
        schedules.make_betas("nope", 1e-4, 2e-2, 10)


@pytest.mark.parametrize("name", ["linear", "quad"])
def test_diffusion_schedule_tables(name):
    ours = schedules.DiffusionSchedule.create(name, 1e-4, 2e-2, 1000, device="cpu")
    ref = jax_sched.DiffusionSchedule.create(name, 1e-4, 2e-2, 1000)
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_padded"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    assert float(ours.alpha_bar(-1)) == 1.0
    assert float(ours.alpha_bar(749)) == float(ref.alpha_bar(749))


@pytest.mark.parametrize("steps", [1, 3, 5, 20])
def test_ddim_reversed_pairs_equal(steps):
    ours = schedules.DDIMSequence.create(1000, steps)
    ref = jax_sched.DDIMSequence.create(1000, steps)
    assert ours.seq == ref.seq and ours.seq_next == ref.seq_next
    np.testing.assert_array_equal(ours.reversed_pairs(), ref.reversed_pairs())
    if steps == 3:
        assert ours.reversed_pairs().tolist() == [[750, 500], [500, 250], [250, -1]]
