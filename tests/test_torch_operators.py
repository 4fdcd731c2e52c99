"""nshmc_tpu_torch's degradation registry and inpainting operator against
nshmc_tpu.operators: every degradation string dispatches to the JAX
package's operator, with the same mask or permutation from the same numpy
seed; the inpainting maps are equal. The other operators have their own
files (tests/test_torch_operators_*.py); tolerances are stated in
tests/_torch_operator_parity.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import operators as jax_ops
from nshmc_tpu_torch import operators
from _torch_operator_parity import EXACT, FFT, PRODUCT, close

DEGRADATIONS = ("sr4", "sr16", "sr_bicubic4", "inpaint_random", "inpaint_box", "deblur_gauss",
                "deblur_aniso", "cs2", "cs4", "color", "denoise", "hdr", "phase_retrieval",
                "deblur_nonlinear")

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


@pytest.mark.parametrize("deg", ["sr", "blur", "inpaint"[:2], "", "Deblur_aniso", "colour"])
def test_unported_degradation_raises(deg):
    """Every degradation of the JAX package is ported: a string that names
    none raises ValueError, as the JAX package's build_operator does."""
    with pytest.raises(ValueError):
        jax_ops.build_operator(deg, 3, 16)
    with pytest.raises(ValueError):
        operators.build_operator(deg, 3, 16, device="cpu")


@pytest.mark.parametrize("deg", DEGRADATIONS)
def test_every_degradation_dispatches_as_jax(deg):
    """At 256^2: the same operator class, the same draws from the same
    numpy seed (masks, box corner, CS permutation, and the generator's state
    after them), and the same H on one input. The nonlinear blur's weights
    come from each package's own generator (see operators/nonlinear_blur.py),
    so only its shape and range are compared here."""
    rng_o, rng_r = np.random.default_rng(11), np.random.default_rng(11)
    ours = operators.build_operator(deg, 3, 256, rng_o, device="cpu")
    ref = jax_ops.build_operator(deg, 3, 256, rng_r)
    assert type(ours).__name__ == type(ref).__name__
    assert (ours.channels, ours.img_dim, ours.is_linear()) == (ref.channels, ref.img_dim,
                                                                ref.is_linear())
    assert rng_o.integers(1 << 30) == rng_r.integers(1 << 30)  # the same draws were made
    for name in ("missing_indices", "kept_indices", "perm", "inv_perm"):
        if hasattr(ref, name):
            close(getattr(ours, name), getattr(ref, name), EXACT, name)
            assert getattr(ours, name).dtype == torch.int64
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3 * 256 * 256)).astype(np.float32)
    out = ours.H(torch.from_numpy(x))
    want = np.asarray(ref.H(jnp.asarray(x)))
    if deg == "deblur_nonlinear":
        assert out.shape == want.shape and float(out.abs().max()) <= 1.0
        return
    tol = {"phase_retrieval": FFT}.get(deg, EXACT if deg.startswith(("inp", "denoise", "hdr"))
                                        else PRODUCT)
    close(out, want, tol, f"{deg} H at 256^2")


def test_default_device_is_cuda():
    """Every operator's tensors go to `device`, which defaults to cuda; on a
    host without a card that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    for deg in ("sr4", "sr_bicubic4", "inpaint_random", "deblur_aniso", "cs2", "color",
                "deblur_nonlinear"):
        with pytest.raises((RuntimeError, AssertionError)):
            operators.build_operator(deg, 3, 16)
    denoise = operators.build_operator("denoise", 3, 16)  # holds no tensor until used
    with pytest.raises((RuntimeError, AssertionError)):
        denoise.H(torch.zeros(1, 768))
