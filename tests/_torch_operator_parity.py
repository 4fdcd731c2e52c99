"""Shared checks of the operator parity tests (tests/test_torch_operators_*.py):
one port operator against its JAX counterpart on the same numpy inputs.

Tolerances (the port's operator tests state them here, once):
  - gathers and permutations: exact;
  - f32 products and the Walsh-Hadamard ladder: max |ours - ref| <= 1e-5 max |ref|;
  - FFT paths and input gradients: <= 1e-4 max |ref|;
  - the two blur networks: atol 2e-4, rtol 1e-3 (tests/test_unet.py's bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

EXACT = 0.0
PRODUCT = 1e-5
FFT = 1e-4
GRAD = 1e-4
NET_ATOL, NET_RTOL = 2e-4, 1e-3


def close(ours, ref, tol, what=""):
    """max |ours - ref| <= tol * max |ref| (tol 0: equal arrays)."""
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    if tol == EXACT:
        np.testing.assert_array_equal(ours, ref, err_msg=what)
        return
    err, scale = float(np.abs(ours - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x max|ref| {scale:.3e}"


def input_gradients(ours, ref, x, y):
    """d/dx ||y - H(x)||^2 by torch autograd and by jax.grad."""
    xt = torch.from_numpy(x).requires_grad_(True)
    ((torch.from_numpy(y) - ours.H(xt)) ** 2).sum().backward()
    g_ref = jax.grad(lambda v: jnp.sum((jnp.asarray(y) - ref.H(v)) ** 2))(jnp.asarray(x))
    return xt.grad, g_ref


def check_svd_operator(ours, ref, seed=0, b=2, gather=False, tol=PRODUCT, n_x=None):
    """Every map of an SVD operator pair on the same random inputs: H, Ht,
    H_pinv, V, Vt, U, Ut, singulars, add_zeros, H_scaled_inv,
    H_dmps_guidance (sigma_y 0.05 and 0) and the input gradient of
    ||y - H(x)||^2. `gather`: the maps are gathers, held exactly. `n_x`:
    the input width, channels * img_dim^2 unless given."""
    rng = np.random.default_rng(seed)
    s_ref = np.asarray(ref.singulars())
    n_x = n_x or ref.channels * ref.img_dim**2
    x = rng.standard_normal((b, n_x)).astype(np.float32)
    n_y = np.asarray(ref.H(jnp.asarray(x))).shape[1]
    y = rng.standard_normal((b, n_y)).astype(np.float32)
    s_vec = rng.standard_normal((b, s_ref.shape[0])).astype(np.float32)
    map_tol = EXACT if gather else tol
    close(ours.singulars(), s_ref, map_tol, "singulars")
    for fn, v in (("H", x), ("V", x), ("Vt", x), ("U", y), ("Ut", y), ("Ht", y),
                  ("H_pinv", y), ("add_zeros", s_vec)):
        out = getattr(ours, fn)(torch.from_numpy(v))
        close(out, getattr(ref, fn)(jnp.asarray(v)), map_tol, fn)
    close(ours.H_scaled_inv(torch.from_numpy(y), 0.3),
          ref.H_scaled_inv(jnp.asarray(y), 0.3), tol, "H_scaled_inv")
    for sigma_y in (0.05, 0.0):
        out = ours.H_dmps_guidance(torch.from_numpy(x), torch.from_numpy(y), 0.7, sigma_y)
        want = ref.H_dmps_guidance(jnp.asarray(x), jnp.asarray(y), 0.7, sigma_y)
        assert np.isfinite(np.asarray(want)).all()
        close(out, want, tol, f"H_dmps_guidance sigma_y {sigma_y}")
    g_ours, g_ref = input_gradients(ours, ref, x, y)
    close(g_ours, g_ref, GRAD, "input gradient")
