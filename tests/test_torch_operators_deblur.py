"""nshmc_tpu_torch's separable-convolution operators (operators/deblur.py)
against nshmc_tpu.operators.deblur on the CPU: the host-built conv matrices,
factors and sort permutations, every SVD map and the input gradient, the
reference-layout variants, and one 256^2 construction each. Tolerances:
tests/_torch_operator_parity.py (index maps and host factors exact, f32
products 1e-5 max|ref|, input gradients 1e-4 max|ref|)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nshmc_tpu import operators as jax_ops
from nshmc_tpu.operators import deblur as jax_deblur
from nshmc_tpu_torch import operators
from nshmc_tpu_torch.operators import deblur
from _torch_operator_parity import EXACT, PRODUCT, check_svd_operator, close

torch.set_num_threads(2)

FACTORS = {"Deblurring": ("u1", "u2", "v1", "v2", "sing_sorted", "perm", "inv_perm"),
           "SRConv": ("u_small", "v_small", "sing", "full_perm", "inv_full_perm")}


def _pairs(d):
    k = np.exp(-0.5 * (np.arange(-2, 3) / 10.0) ** 2)
    return {
        "deblur_gauss": lambda m, **kw: m.build_operator("deblur_gauss", 3, d,
                                                         np.random.default_rng(0), **kw),
        "deblur_aniso": lambda m, **kw: m.build_operator("deblur_aniso", 3, d,
                                                         np.random.default_rng(0), **kw),
        "sr_bicubic2": lambda m, **kw: m.build_operator("sr_bicubic2", 3, d,
                                                        np.random.default_rng(0), **kw),
        "sr_bicubic4": lambda m, **kw: m.build_operator("sr_bicubic4", 3, d,
                                                        np.random.default_rng(0), **kw),
        # no threshold: every singular value nonzero
        "deblur_thresh0": lambda m, **kw: m.Deblurring.create(k, 3, d, zero_thresh=0.0, **kw),
        "srconv_thresh0": lambda m, **kw: m.SRConv.create(k / k.sum(), 3, d, stride=2,
                                                          zero_thresh=0.0, **kw),
    }


def _build(name, d):
    make = _pairs(d)[name]
    return make(operators, device="cpu"), make(jax_ops)


def _factor_names(op):
    return FACTORS["SRConv" if isinstance(op, deblur.SRConv) else "Deblurring"]


@pytest.mark.parametrize("name", sorted(_pairs(16)))
@pytest.mark.parametrize("d", [16, 32])
def test_maps_match_jax(name, d):
    ours, ref = _build(name, d)
    assert type(ours).__name__ == type(ref).__name__
    for f in _factor_names(ours):  # host numpy in both packages: the same bits
        close(getattr(ours, f), getattr(ref, f), EXACT, f)
        assert getattr(ours, f).dtype == (torch.int64 if "perm" in f else torch.float32)
    check_svd_operator(ours, ref, seed=d)


@pytest.mark.parametrize("name", ["deblur_gauss", "deblur_aniso", "sr_bicubic4"])
def test_256_construction_matches_jax(name):
    ours, ref = _build(name, 256)
    for f in _factor_names(ours):
        close(getattr(ours, f), getattr(ref, f), EXACT, f)
    x = np.random.default_rng(1).standard_normal((1, 3 * 256 * 256)).astype(np.float32)
    close(ours.H(torch.from_numpy(x)), ref.H(jnp.asarray(x)), PRODUCT, "H at 256^2")


@pytest.mark.parametrize("d,stride", [(16, 2), (16, 4), (32, 4)])
def test_host_matrices_match_jax(d, stride):
    k = np.random.default_rng(d).uniform(0.1, 1, 9)
    np.testing.assert_array_equal(deblur._conv1d_matrix(k, d), jax_deblur._conv1d_matrix(k, d))
    np.testing.assert_array_equal(deblur._srconv_matrix(k, d, stride),
                                  jax_deblur._srconv_matrix(k, d, stride))


def test_separable_h_is_the_blur():
    """H = the 2D separable convolution (rows by k1, columns by k2) with
    zero padding, channel by channel."""
    xs = np.arange(-4, 5)
    k1, k2 = np.exp(-0.5 * xs**2), np.exp(-0.5 * (xs / 20.0) ** 2)
    ours = operators.Deblurring2D.create(k1, k2, 3, 16, zero_thresh=0.0, device="cpu")
    h1 = deblur._conv1d_matrix(k1 / k1.sum(), 16)
    h2 = deblur._conv1d_matrix(k2 / k2.sum(), 16)
    x = np.random.default_rng(0).standard_normal((2, 3, 16, 16))
    want = np.einsum("ij,bcjk,lk->bcil", h1, x, h2).reshape(2, -1)
    np.testing.assert_allclose(ours.H(torch.from_numpy(x.astype(np.float32).reshape(2, -1))),
                               want, atol=2e-5)


def test_srconv_singulars_interleave():
    """jnp.repeat -> repeat_interleave: each value once per channel in a row."""
    ours, ref = _build("sr_bicubic4", 16)
    s = ours.singulars().numpy()
    np.testing.assert_array_equal(s.reshape(-1, 3), np.repeat(ours.sing.numpy()[:, None], 3, 1))
    close(ours.singulars(), ref.singulars(), EXACT, "singulars")


@pytest.mark.parametrize("cls", ["DeblurringReferenceLayout", "Deblurring2DReferenceLayout"])
def test_reference_layout_matches_jax(cls):
    d = 16
    xs = np.arange(-4, 5)
    h1 = jax_deblur._conv1d_matrix(np.exp(-0.5 * xs**2) / np.exp(-0.5 * xs**2).sum(), d)
    h2 = jax_deblur._conv1d_matrix(np.ones(9) / 9, d)
    u1, s1, v1t = np.linalg.svd(h1)
    u2, s2, v2t = np.linalg.svd(h2)
    order = np.random.default_rng(0).permutation(d * d)  # an injected order
    for inject in (None, order):
        ours = getattr(deblur, cls).create_with_factors(u1, s1, v1t.T, u2, s2, v2t.T, 3, d,
                                                        order=inject, device="cpu")
        ref = getattr(jax_deblur, cls).create_with_factors(u1, s1, v1t.T, u2, s2, v2t.T, 3, d,
                                                           order=inject)
        for f in FACTORS["Deblurring"]:
            close(getattr(ours, f), getattr(ref, f), EXACT, f)
        check_svd_operator(ours, ref, seed=3)
