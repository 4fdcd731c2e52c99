"""nshmc_tpu_torch's nonlinear operators (operators/nonlinear.py) against
nshmc_tpu.operators.nonlinear on the CPU: the centered FFTs in both of the
port's lowerings (torch.fft and the matmul DFT, complex and real-pair)
against jnp.fft, PhaseRetrieval and HDR with proj / eq_var, and the input
gradient of ||y - H(x)||^2 against jax.grad, also where |FFT| is 0.
Tolerances: tests/_torch_operator_parity.py (FFT paths and gradients
1e-4 max|ref|; the HDR clip, an elementwise map, exact)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import operators as jax_ops
from nshmc_tpu_torch import operators
from nshmc_tpu_torch.operators import nonlinear
from _torch_operator_parity import EXACT, FFT, GRAD, close, input_gradients

torch.set_num_threads(2)


@pytest.fixture(params=["fft", "matmul"])
def lowering(request):
    operators.set_fft_impl(request.param)
    yield request.param
    operators.set_fft_impl("auto")


def _jnp_fft2c(x, inverse=False):
    f = jnp.fft.ifftn if inverse else jnp.fft.fftn
    return jnp.fft.fftshift(f(jnp.fft.ifftshift(x, axes=(-2, -1)), axes=(-2, -1), norm="ortho"),
                            axes=(-2, -1))


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (1, 2, 24, 40)])
def test_centered_ffts_match_jnp_fft(lowering, shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    for inverse, fn in ((False, operators.fft2c), (True, operators.ifft2c)):
        close(fn(torch.from_numpy(x)), _jnp_fft2c(jnp.asarray(x), inverse), FFT, fn.__name__)
    # the real-pair forms, on a complex and a real input
    for inverse, fn in ((False, nonlinear.fft2c_pair), (True, nonlinear.ifft2c_pair)):
        want = np.asarray(_jnp_fft2c(jnp.asarray(x), inverse))
        yr, yi = fn(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()))
        close(yr, want.real, FFT, "pair real")
        close(yi, want.imag, FFT, "pair imag")
        want = np.asarray(_jnp_fft2c(jnp.asarray(x.real), inverse))
        yr, yi = fn(torch.from_numpy(x.real.copy()))
        close(yr, want.real, FFT, "pair of a real input, real")
        close(yi, want.imag, FFT, "pair of a real input, imag")


def test_auto_is_torch_fft_and_bad_names_raise():
    assert not nonlinear._use_matmul()
    with pytest.raises(ValueError):
        operators.set_fft_impl("mxu")


@pytest.mark.parametrize("d", [16, 32])
def test_phase_retrieval_matches_jax(lowering, d):
    ours = operators.build_operator("phase_retrieval", 3, d, device="cpu")
    ref = jax_ops.build_operator("phase_retrieval", 3, d)
    assert ours.pad == ref.pad == 64 and not ours.is_linear()  # 64 whatever img_dim is
    rng = np.random.default_rng(d)
    x = rng.uniform(-1, 1, (2, 3 * d * d)).astype(np.float32)
    y = np.array(ref.H(jnp.asarray(x)))
    close(ours.H(torch.from_numpy(x)), y, FFT, "H")
    close(ours.H_pinv(torch.from_numpy(y)), ref.H_pinv(jnp.asarray(y)), FFT, "H_pinv")
    x2 = rng.uniform(-1, 1, x.shape).astype(np.float32)
    for alpha in (1.0, 0.5):
        close(ours.proj(torch.from_numpy(x2), torch.from_numpy(y), alpha),
              ref.proj(jnp.asarray(x2), jnp.asarray(y), alpha), FFT, f"proj alpha {alpha}")
    assert ours.eq_var(0.01) == pytest.approx(float(ref.eq_var(0.01)))
    g_ours, g_ref = input_gradients(ours, ref, x2, y)
    close(g_ours, g_ref, GRAD, "input gradient")


def test_phase_gradient_at_zero_magnitude():
    """At x = 0 every |FFT| is 0: torch's complex abs gives a zero
    gradient there, and so does jax.grad."""
    ours = operators.build_operator("phase_retrieval", 3, 16, device="cpu")
    ref = jax_ops.build_operator("phase_retrieval", 3, 16)
    x = np.zeros((1, 3 * 16 * 16), np.float32)
    y = np.random.default_rng(0).uniform(0, 1, (1, 3 * 144 * 144)).astype(np.float32)
    g_ours, g_ref = input_gradients(ours, ref, x, y)
    assert np.isfinite(np.asarray(g_ref)).all()
    close(g_ours, g_ref, EXACT, "gradient at |FFT| = 0")


def test_hdr_matches_jax():
    ours = operators.build_operator("hdr", 3, 16, device="cpu")
    ref = jax_ops.build_operator("hdr", 3, 16)
    assert not ours.is_linear()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, (2, 768)).astype(np.float32)
    y = np.array(ref.H(jnp.asarray(x)))
    assert (np.abs(y) == 1).any() and (np.abs(y) < 1).any()  # both sides of the clip
    close(ours.H(torch.from_numpy(x)), y, EXACT, "H")
    close(ours.H_pinv(torch.from_numpy(y)), ref.H_pinv(jnp.asarray(y)), EXACT, "H_pinv")
    x2 = rng.uniform(-1, 1, x.shape).astype(np.float32)
    for alpha in (1.0, 0.5):
        close(ours.proj(torch.from_numpy(x2), torch.from_numpy(y), alpha),
              ref.proj(jnp.asarray(x2), jnp.asarray(y), alpha), EXACT, f"proj alpha {alpha}")
    assert ours.eq_var(0.2) == pytest.approx(float(ref.eq_var(0.2)))
    g_ours, g_ref = input_gradients(ours, ref, x2, y)
    close(g_ours, g_ref, GRAD, "input gradient")
