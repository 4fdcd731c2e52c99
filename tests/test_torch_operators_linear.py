"""nshmc_tpu_torch's linear operators (operators/linear.py, base.py,
general.py) against nshmc_tpu.operators on the CPU: Denoising,
SuperResolution, Colorization, the Inpainting maps the base class derives,
GeneralH and the mask helpers. Tolerances: tests/_torch_operator_parity.py
(gathers exact, f32 products 1e-5 max|ref|, input gradients 1e-4 max|ref|)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import operators as jax_ops
from nshmc_tpu_torch import operators
from _torch_operator_parity import EXACT, PRODUCT, check_svd_operator, close

torch.set_num_threads(2)


@pytest.mark.parametrize("deg,d", [("sr2", 16), ("sr4", 16), ("sr4", 32), ("sr16", 32),
                                   ("color", 16), ("denoise", 16), ("inpaint_random", 16),
                                   ("inpaint_box", 256)])
def test_svd_maps_match_jax(deg, d):
    ours = operators.build_operator(deg, 3, d, np.random.default_rng(5), device="cpu")
    ref = jax_ops.build_operator(deg, 3, d, np.random.default_rng(5))
    assert type(ours).__name__ == type(ref).__name__ and ours.is_linear()
    gather = deg.startswith(("inpaint", "denoise"))
    check_svd_operator(ours, ref, seed=d, gather=gather, b=1 if d == 256 else 2)


@pytest.mark.parametrize("ratio", [2, 4, 16])
def test_superresolution_factors_and_tile_layout(ratio):
    ours = operators.SuperResolution.create(3, 32, ratio, device="cpu")
    ref = jax_ops.SuperResolution.create(3, 32, ratio)
    close(ours.v_small, ref.v_small, EXACT, "v_small")
    close(ours.u_sign, ref.u_sign, EXACT, "u_sign")
    close(ours.singulars_small, ref.singulars_small, EXACT, "singulars_small")
    # jnp.tile -> Tensor.repeat: the one patch value 1/r, c * y^2 times
    assert ours.singulars().shape == (3 * (32 // ratio) ** 2,)
    np.testing.assert_allclose(ours.singulars().numpy(), 1.0 / ratio, rtol=1e-6)


def test_superresolution_h_is_block_mean():
    ours = operators.SuperResolution.create(3, 16, 4, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 16, 16))
                         .astype(np.float32))
    want = x.reshape(2, 3, 4, 4, 4, 4).mean(dim=(3, 5)).reshape(2, -1)
    np.testing.assert_allclose(ours.H(x.reshape(2, -1)).numpy(), want.numpy(), atol=1e-6)


def test_colorization_factors_match_jax():
    ours = operators.Colorization.create(16, device="cpu")
    ref = jax_ops.Colorization.create(16)
    for name in ("u_sign", "singular0", "v_small"):
        close(getattr(ours, name), getattr(ref, name), EXACT, name)


def test_bf16_input_is_promoted_as_jax_does():
    """A bf16 image through an f32 factor product computes in f32, as JAX's
    type promotion of the einsum does."""
    ours = operators.SuperResolution.create(3, 16, 4, device="cpu")
    ref = jax_ops.SuperResolution.create(3, 16, 4)
    x = np.random.default_rng(2).standard_normal((2, 768)).astype(np.float32)
    out = ours.H(torch.from_numpy(x).to(torch.bfloat16))
    want = ref.H(jnp.asarray(x, jnp.bfloat16))
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    close(out, want, PRODUCT, "H of bf16")


@pytest.mark.parametrize("shape", [(12, 48), (48, 48)])
def test_general_h_matches_jax(shape):
    h = np.random.default_rng(3).standard_normal(shape)
    ours = operators.GeneralH.create(h, device="cpu")
    ref = jax_ops.GeneralH.create(h)
    check_svd_operator(ours, ref, seed=4, n_x=shape[1])
    x = np.random.default_rng(5).standard_normal((2, shape[1])).astype(np.float32)
    np.testing.assert_allclose(ours.H(torch.from_numpy(x)).numpy(), x @ h.T, atol=1e-4)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_random_inpainting_indices(kind):
    gen = (torch.Generator().manual_seed(0) if kind == "torch" else np.random.default_rng(0))
    missing = operators.random_inpainting_indices(gen, 16)
    assert missing.shape == (3 * int(256 * 0.92),) and np.all(np.diff(missing) > 0)
    pixels = missing.reshape(-1, 3)
    assert (pixels == pixels[:, :1] + np.arange(3)).all()  # whole pixels, pixel-major
    if kind == "numpy":  # the draw build_operator makes, and so the JAX one
        ref = jax_ops.build_operator("inpaint_random", 3, 16, np.random.default_rng(0))
        np.testing.assert_array_equal(missing, np.asarray(ref.missing_indices))


def test_box_indices_match_jax():
    np.testing.assert_array_equal(operators.box_inpainting_indices(64, 3, 5, 9, size=20),
                                  jax_ops.box_inpainting_indices(64, 3, 5, 9, size=20))
