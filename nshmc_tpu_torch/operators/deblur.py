"""Separable-convolution SVD operators: Gaussian and anisotropic deblurring,
and strided-convolution super-resolution (port of
nshmc_tpu/operators/deblur.py).

The 1D convolution matrices are built and SVD'd on the host in numpy, by
this module's copy of the JAX package's construction code (its loop bounds
included), and the factors are moved to the operator's device as float32.
Each apply is two matrix products, A @ X @ B^T in that order, where the JAX
package writes a three-operand einsum. The products run in full f32: the
port never turns on TF32 for matmuls (torch's default leaves it off).

The spectral layout is the JAX package's: channel-major with per-channel
tiled singular values, sorted descending by a stable numpy argsort, so
`perm` and `inv_perm` equal the JAX ones bit for bit. The reference-layout
variants keep the reference's pixel-major layout (see the JAX module's
docstring for why that layout mixes channels).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import SVDOperator, host_tensor, pad_zeros, promote


def _conv1d_matrix(kernel: np.ndarray, img_dim: int) -> np.ndarray:
    """Dense 1D convolution matrix with zero padding
    (nshmc_tpu/operators/deblur.py:30-40)."""
    k = np.asarray(kernel, np.float64)
    h = np.zeros((img_dim, img_dim))
    half = k.shape[0] // 2
    for i in range(img_dim):
        for j in range(i - half, i + half):
            if 0 <= j < img_dim:
                h[i, j] = k[j - i + half]
    return h


def _srconv_matrix(kernel: np.ndarray, img_dim: int, stride: int) -> np.ndarray:
    """Strided 1D conv matrix with reflective padding
    (nshmc_tpu/operators/deblur.py:43-57)."""
    k = np.asarray(kernel, np.float64)
    small = img_dim // stride
    h = np.zeros((small, img_dim))
    half = k.shape[0] // 2
    for i in range(stride // 2, img_dim + stride // 2, stride):
        for j in range(i - half, i + half):
            j_eff = j
            if j_eff < 0:
                j_eff = -j_eff - 1
            if j_eff >= img_dim:
                j_eff = (img_dim - 1) - (j_eff - img_dim)
            h[i // stride, j_eff] += k[j - i + half]
    return h


def _sandwich(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ x @ b over the last two axes of x, left product first."""
    return torch.matmul(torch.matmul(a, promote(x, a)), b)


def _sorted_spectrum(s1, s2, zero_thresh, order=None):
    """The Kronecker singular values with those below `zero_thresh` zeroed,
    their descending order (stable numpy argsort unless `order` is given)
    and its inverse."""
    s1 = np.where(np.asarray(s1) < zero_thresh, 0.0, s1)
    s2 = np.where(np.asarray(s2) < zero_thresh, 0.0, s2)
    sing = np.outer(s1, s2).reshape(-1)
    order = np.asarray(order) if order is not None else np.argsort(-sing, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0])
    return sing[order], order, inv


class _SeparableDeblur(SVDOperator):
    """Shared machinery for separable-conv SVD operators on square images
    (nshmc_tpu/operators/deblur.py:60-123): H(x) = U1 @ X @ U2^T after the
    spectral scaling; flat spectral index = c * d^2 + spectral pixel, sorted
    descending by singular value through `perm`."""

    def __init__(self, u1, u2, v1, v2, sing_sorted, perm, inv_perm, channels: int,
                 img_dim: int, device="cuda"):
        self.u1, self.u2 = host_tensor(u1, device), host_tensor(u2, device)
        self.v1, self.v2 = host_tensor(v1, device), host_tensor(v2, device)
        self.sing_sorted = host_tensor(sing_sorted, device)  # (d^2,) descending
        self.perm = host_tensor(perm, device)  # gather for Vt / Ut
        self.inv_perm = host_tensor(inv_perm, device)  # gather for V / U
        self.channels, self.img_dim = channels, img_dim

    @classmethod
    def _from_kernels(cls, k1, k2, channels, img_dim, zero_thresh, device):
        u1, s1, v1t = np.linalg.svd(_conv1d_matrix(k1, img_dim), full_matrices=True)
        u2, s2, v2t = np.linalg.svd(_conv1d_matrix(k2, img_dim), full_matrices=True)
        sing, order, inv = _sorted_spectrum(s1, s2, zero_thresh)
        return cls(u1, u2, v1t.T, v2t.T, sing, order, inv, channels, img_dim, device)

    def _img(self, vec):
        d = self.img_dim
        return vec.reshape(vec.shape[0], self.channels, d, d)

    def _from_spectral(self, vec, a, b):
        """V / U: un-permute, then a @ X @ b^T."""
        bsz, d = vec.shape[0], self.img_dim
        spec = vec.reshape(bsz, self.channels, d * d)[:, :, self.inv_perm]
        out = _sandwich(a, spec.reshape(bsz, self.channels, d, d), b.T)
        return out.reshape(bsz, -1)

    def _to_spectral(self, vec, a, b):
        """Vt / Ut: a^T @ X @ b, then permute."""
        bsz = vec.shape[0]
        spec = _sandwich(a.T, self._img(vec), b)
        return spec.reshape(bsz, self.channels, -1)[:, :, self.perm].reshape(bsz, -1)

    def V(self, vec):
        return self._from_spectral(vec, self.v1, self.v2)

    def Vt(self, vec):
        return self._to_spectral(vec, self.v1, self.v2)

    def U(self, vec):
        return self._from_spectral(vec, self.u1, self.u2)

    def Ut(self, vec):
        return self._to_spectral(vec, self.u1, self.u2)

    def singulars(self):
        return self.sing_sorted.repeat(self.channels)  # jnp.tile

    def add_zeros(self, vec):
        return vec.reshape(vec.shape[0], -1)


def _normalized(kernel) -> np.ndarray:
    k = np.asarray(kernel, np.float64)
    return k / k.sum()


class Deblurring(_SeparableDeblur):
    """Isotropic separable deblurring (nshmc_tpu/operators/deblur.py:148-168)."""

    @classmethod
    def create(cls, kernel, channels: int, img_dim: int, zero_thresh: float = 3e-2,
               device="cuda"):
        k = _normalized(kernel)
        return cls._from_kernels(k, k, channels, img_dim, zero_thresh, device)

    @classmethod
    def gaussian(cls, channels: int = 3, img_dim: int = 256, sigma: float = 10.0,
                 device="cuda"):
        """5-tap Gaussian kernel of the reference run config."""
        xs = np.arange(-2, 3, dtype=np.float64)
        return cls.create(np.exp(-0.5 * (xs / sigma) ** 2), channels, img_dim, device=device)


class Deblurring2D(_SeparableDeblur):
    """Anisotropic separable deblurring: kernel1 along rows, kernel2 along
    columns (nshmc_tpu/operators/deblur.py:171-192)."""

    @classmethod
    def create(cls, kernel1, kernel2, channels: int, img_dim: int,
               zero_thresh: float = 3e-2, device="cuda"):
        return cls._from_kernels(_normalized(kernel1), _normalized(kernel2), channels,
                                 img_dim, zero_thresh, device)

    @classmethod
    def aniso(cls, channels: int = 3, img_dim: int = 256, device="cuda"):
        """9-tap sigma=1 x sigma=20 anisotropic pair."""
        xs = np.arange(-4, 5, dtype=np.float64)
        return cls.create(np.exp(-0.5 * (xs / 1.0) ** 2), np.exp(-0.5 * (xs / 20.0) ** 2),
                          channels, img_dim, device=device)


class _ReferenceLayoutMixin:
    """Pixel-major spectral layout with the reference's tiled singular
    values (nshmc_tpu/operators/deblur.py:195-266). Use only where exact
    parity with upstream measurements is required; build it from the same
    SVD routine as the run being reproduced (`create_with_factors`)."""

    @classmethod
    def create_with_factors(cls, u1, s1, v1, u2, s2, v2, channels, img_dim,
                            zero_thresh: float = 3e-2, order=None, device="cuda"):
        """Build from explicit 1D-conv SVD factors (u @ diag(s) @ v.T);
        `order` optionally injects the descending-sort permutation."""
        sing, order, inv = _sorted_spectrum(s1, s2, zero_thresh, order)
        return cls(u1, u2, v1, v2, sing, order, inv, channels, img_dim, device)

    def _from_spectral(self, vec, a, b):
        bsz, d = vec.shape[0], self.img_dim
        spec = vec.reshape(bsz, d * d, self.channels)[:, self.inv_perm, :]
        x = spec.transpose(1, 2).reshape(bsz, self.channels, d, d)
        return _sandwich(a, x, b.T).reshape(bsz, -1)

    def _to_spectral(self, vec, a, b):
        bsz = vec.shape[0]
        spec = _sandwich(a.T, self._img(vec), b)
        spec = spec.reshape(bsz, self.channels, -1)[:, :, self.perm]
        return spec.transpose(1, 2).reshape(bsz, -1)


class DeblurringReferenceLayout(_ReferenceLayoutMixin, Deblurring):
    """Deblurring with the reference's pixel-major spectral layout and
    `[s, s, s]`-tiled singular values."""


class Deblurring2DReferenceLayout(_ReferenceLayoutMixin, Deblurring2D):
    """Deblurring2D with the reference's spectral layout."""


class SRConv(SVDOperator):
    """Strided-convolution super-resolution with reflective padding
    (nshmc_tpu/operators/deblur.py:279-388). Pixel-major spectral layout:
    the first small_dim^2 spectral pixels carry the rank block, mapped into
    the top-left block of the image grid by `full_perm`."""

    def __init__(self, u_small, v_small, sing, full_perm, inv_full_perm, channels: int,
                 img_dim: int, ratio: int, device="cuda"):
        self.u_small = host_tensor(u_small, device)  # (small, small)
        self.v_small = host_tensor(v_small, device)  # (d, d)
        self.sing = host_tensor(sing, device)  # (small^2,)
        self.full_perm = host_tensor(full_perm, device)  # (d^2,)
        self.inv_full_perm = host_tensor(inv_full_perm, device)
        self.channels, self.img_dim, self.ratio = channels, img_dim, ratio

    @property
    def small_dim(self):
        return self.img_dim // self.ratio

    @classmethod
    def create(cls, kernel, channels: int, img_dim: int, stride: int,
               zero_thresh: float = 3e-2, device="cuda"):
        h = _srconv_matrix(np.asarray(kernel, np.float64), img_dim, stride)
        u, s, vt = np.linalg.svd(h, full_matrices=True)
        s = np.where(s < zero_thresh, 0.0, s)
        small = img_dim // stride
        sing = np.outer(s, s).reshape(-1)
        # P_1: spectral pixel (i, j), i < small, maps to image position d*i+j
        perm = np.asarray(
            [img_dim * i + j for i in range(small) for j in range(small)]
            + [img_dim * i + j for i in range(small) for j in range(small, img_dim)],
            np.int64)
        full_perm = np.arange(img_dim**2)
        full_perm[: perm.shape[0]] = perm
        inv = np.empty_like(full_perm)
        inv[full_perm] = np.arange(img_dim**2)
        return cls(u, vt.T, sing, full_perm, inv, channels, img_dim, stride, device)

    @classmethod
    def bicubic(cls, channels: int, img_dim: int, factor: int, device="cuda"):
        """Bicubic downsampling kernel (nshmc_tpu/operators/deblur.py:331-349)."""

        def bicubic_kernel(x, a=-0.5):
            ax = abs(x)
            if ax <= 1:
                return (a + 2) * ax**3 - (a + 3) * ax**2 + 1
            elif 1 < ax < 2:
                return a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a
            return 0.0

        k = np.zeros(factor * 4)
        for i in range(factor * 4):
            x = (1 / factor) * (i - np.floor(factor * 4 / 2) + 0.5)
            k[i] = bicubic_kernel(x)
        return cls.create(k / k.sum(), channels, img_dim, stride=factor, device=device)

    def V(self, vec):
        b, d = vec.shape[0], self.img_dim
        spec = vec.reshape(b, d * d, self.channels)[:, self.inv_full_perm, :]
        x = spec.transpose(1, 2).reshape(b, self.channels, d, d)
        return _sandwich(self.v_small, x, self.v_small.T).reshape(b, -1)

    def Vt(self, vec):
        b, d = vec.shape[0], self.img_dim
        x = vec.reshape(b, self.channels, d, d)
        spec = _sandwich(self.v_small.T, x, self.v_small)
        spec = spec.reshape(b, self.channels, d * d)[:, :, self.full_perm]
        return spec.transpose(1, 2).reshape(b, -1)

    def U(self, vec):
        b, s = vec.shape[0], self.small_dim
        x = vec.reshape(b, s * s, self.channels).transpose(1, 2).reshape(b, self.channels, s, s)
        return _sandwich(self.u_small, x, self.u_small.T).reshape(b, -1)

    def Ut(self, vec):
        b, s = vec.shape[0], self.small_dim
        x = vec.reshape(b, self.channels, s, s)
        spec = _sandwich(self.u_small.T, x, self.u_small)
        return spec.reshape(b, self.channels, s * s).transpose(1, 2).reshape(b, -1)

    def singulars(self):
        # jnp.repeat: each singular value once per channel, interleaved
        return self.sing.repeat_interleave(self.channels)

    def add_zeros(self, vec):
        return pad_zeros(vec, vec.shape[1] * self.ratio**2)
