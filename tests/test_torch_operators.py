"""nshmc_tpu_torch inpainting operator against nshmc_tpu.operators: the same
mask from the same numpy seed, and the same H / Ht / H_pinv / V / Vt."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import operators as jax_ops
from nshmc_tpu_torch import operators

torch.set_num_threads(2)


def _pair(deg="inpaint_random", seed=0, d=16):
    ours = operators.build_operator(deg, 3, d, np.random.default_rng(seed), device="cpu")
    ref = jax_ops.build_operator(deg, 3, d, np.random.default_rng(seed))
    return ours, ref


@pytest.mark.parametrize("deg,d", [("inpaint_random", 16), ("inpaint_box", 256)])
def test_index_maps_equal(deg, d):
    ours, ref = _pair(deg, d=d)
    np.testing.assert_array_equal(ours.missing_indices.numpy(), np.asarray(ref.missing_indices))
    np.testing.assert_array_equal(ours.kept_indices.numpy(), np.asarray(ref.kept_indices))


def test_random_mask_drops_whole_pixels():
    ours, _ = _pair()
    missing = ours.missing_indices.numpy()
    assert missing.size == 3 * int(16**2 * 0.92)
    pixels = missing.reshape(-1, 3)
    assert (pixels == pixels[:, :1] + np.arange(3)).all()  # pixel-major interleave


@pytest.mark.parametrize("fn", ["H", "Ht", "H_pinv", "V", "Vt"])
def test_maps_equal(fn):
    ours, ref = _pair(seed=3)
    rng = np.random.default_rng(7)
    n_in = ref.kept_indices.shape[0] if fn in ("Ht", "H_pinv") else 3 * 16 * 16
    vec = rng.standard_normal((2, n_in)).astype(np.float32)
    out = getattr(ours, fn)(torch.from_numpy(vec)).numpy()
    np.testing.assert_array_equal(out, np.asarray(getattr(ref, fn)(jnp.asarray(vec))))


def test_image_maps_and_flatten_order():
    ours, ref = _pair(seed=4)
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 3)).astype(np.float32)
    flat = operators.flatten_image(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(flat, x.transpose(0, 3, 1, 2).reshape(2, -1))
    y = ours.H_img(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(ref.H_img(jnp.asarray(x))))
    np.testing.assert_array_equal(ours.H_pinv_img(y).numpy(),
                                  np.asarray(ref.H_pinv_img(jnp.asarray(y.numpy()))))


def test_unported_degradation_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        operators.build_operator("sr4", 3, 16, device="cpu")
