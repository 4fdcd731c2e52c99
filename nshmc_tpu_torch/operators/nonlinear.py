"""Nonlinear forward operators: phase retrieval and HDR clipping (port of
nshmc_tpu/operators/nonlinear.py).

  PhaseRetrieval — |FFT2c(zero_pad(x))| with the fastmri centered-FFT
                   convention (ifftshift -> orthonormal FFT -> fftshift)
  HDR            — clip(x / 0.5, -1, 1)

Both expose the `proj` prox operators and `eq_var` measurement-variance
rescalers some samplers use.

The 2D DFT has two lowerings, as in the JAX package: "fft" is `torch.fft`
(cuFFT on the card) in complex64; "matmul" is the orthonormal DFT as
matrix products on f32 real and imaginary planes. `set_fft_impl` picks
one; "auto", the default, means `torch.fft` on every torch device (the JAX
package's "auto" picks the matrix products only on a TPU runtime without an
FFT, which has no counterpart here).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import Operator

_FFT_IMPL = "auto"


def set_fft_impl(impl: str) -> None:
    """Select the DFT lowering of this module: 'fft', 'matmul' or 'auto'
    ('auto' is 'fft'). It holds for every later call in the process."""
    global _FFT_IMPL
    if impl not in ("fft", "matmul", "auto"):
        raise ValueError(f"unknown FFT lowering {impl!r}")
    _FFT_IMPL = impl


def _use_matmul() -> bool:
    return _FFT_IMPL == "matmul"


def _dft_mat(n: int, inverse: bool) -> np.ndarray:
    """Orthonormal DFT matrix (symmetric), built on the host."""
    k = np.arange(n)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(k, k) / n) / np.sqrt(n)
    return w.astype(np.complex64)


def _fftn2_matmul(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """W_m @ X @ W_n in complex64 (both W symmetric)."""
    m, n = x.shape[-2], x.shape[-1]
    wm = torch.as_tensor(_dft_mat(m, inverse), device=x.device)
    wn = torch.as_tensor(_dft_mat(n, inverse), device=x.device)
    return torch.matmul(wm, torch.matmul(x.to(torch.complex64), wn))


def _fftn2_matmul_pair(xr, xi, inverse: bool):
    """W_m (Xr + i Xi) W_n on f32 real and imaginary planes; xi may be None
    (a real input)."""
    m, n = xr.shape[-2], xr.shape[-1]
    wm, wn = _dft_mat(m, inverse), _dft_mat(n, inverse)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=xr.device)
    ar, ai, br, bi = as_t(wm.real), as_t(wm.imag), as_t(wn.real), as_t(wn.imag)
    mm = torch.matmul
    xr = xr.float()
    if xi is None:  # T = X @ W_n
        tr, ti = mm(xr, br), mm(xr, bi)
    else:
        xi = xi.float()
        tr = mm(xr, br) - mm(xi, bi)
        ti = mm(xr, bi) + mm(xi, br)
    return mm(ar, tr) - mm(ai, ti), mm(ar, ti) + mm(ai, tr)  # Y = W_m @ T


def _shift_pair(fn, pair):
    return tuple(None if p is None else fn(p, dim=(-2, -1)) for p in pair)


def fft2c_pair(xr, xi=None):
    """Centered orthonormal 2D FFT on (real, imag) f32 planes."""
    xr, xi = _shift_pair(torch.fft.ifftshift, (xr, xi))
    return _shift_pair(torch.fft.fftshift, _fftn2_matmul_pair(xr, xi, inverse=False))


def ifft2c_pair(xr, xi=None):
    """Centered orthonormal 2D inverse FFT on (real, imag) f32 planes."""
    xr, xi = _shift_pair(torch.fft.ifftshift, (xr, xi))
    return _shift_pair(torch.fft.fftshift, _fftn2_matmul_pair(xr, xi, inverse=True))


def fft2c(x: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2D FFT over the last two axes."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    if _use_matmul():
        x = _fftn2_matmul(x, inverse=False)
    else:
        x = torch.fft.fftn(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


def ifft2c(x: torch.Tensor) -> torch.Tensor:
    """Centered orthonormal 2D inverse FFT over the last two axes."""
    x = torch.fft.ifftshift(x, dim=(-2, -1))
    if _use_matmul():
        x = _fftn2_matmul(x, inverse=True)
    else:
        x = torch.fft.ifftn(x, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(x, dim=(-2, -1))


class PhaseRetrieval(Operator):
    """Oversampled Fourier-magnitude measurement
    (nshmc_tpu/operators/nonlinear.py:155-244): H(x) = |FFT2c(zero_pad(x))|
    per channel, flattened channel-major to (B, C * (d + 2 pad)^2). The pad
    is oversample/8 * 256 whatever img_dim is, as in the reference. It
    holds no tensors: it runs on the device of its input, and `device` is
    where its callers keep that input."""

    def __init__(self, channels: int = 3, img_dim: int = 256, pad: int = 64, device="cuda"):
        self.channels, self.img_dim, self.pad = channels, img_dim, pad
        self.device = torch.device(device)

    @classmethod
    def create(cls, channels: int = 3, img_dim: int = 256, oversample: float = 2.0,
               device="cuda"):
        return cls(channels, img_dim, int((oversample / 8.0) * 256), device)

    def is_linear(self):
        return False

    @property
    def big(self):
        return self.img_dim + 2 * self.pad

    def _padded(self, vec):
        d, p = self.img_dim, self.pad
        return F.pad(vec.reshape(vec.shape[0], self.channels, d, d).float(), (p, p, p, p))

    def _crop(self, img):
        p = self.pad
        return img[:, :, p:-p, p:-p]

    def H(self, vec):
        padded = self._padded(vec)
        if _use_matmul():
            yr, yi = fft2c_pair(padded)
            amplitude = torch.sqrt(yr * yr + yi * yi)
        else:
            amplitude = torch.abs(fft2c(padded.to(torch.complex64)))
        return amplitude.reshape(vec.shape[0], -1)

    def H_pinv(self, vec):
        b = vec.shape[0]
        y = vec.reshape(b, self.channels, self.big, self.big).float()
        if _use_matmul():
            xr, xi = ifft2c_pair(y)
            x = torch.sqrt(xr * xr + xi * xi)
        else:
            x = torch.abs(ifft2c(y.to(torch.complex64)))
        return self._crop(x).reshape(b, -1)

    def proj(self, x_vec, y_vec, alpha_obs: float = 1.0, eps: float = 1e-8):
        """Magnitude-projection prox (nshmc_tpu/operators/nonlinear.py:222-239)."""
        b = x_vec.shape[0]
        y = y_vec.reshape(b, self.channels, self.big, self.big) * np.sqrt(alpha_obs)
        padded = self._padded(x_vec)
        if _use_matmul():
            fr, fi = fft2c_pair(padded)
            mag = torch.sqrt(fr * fr + fi * fi) + eps
            prox = self._crop(ifft2c_pair(fr * y / mag, fi * y / mag)[0])
        else:
            fx = fft2c(padded.to(torch.complex64))
            prox = torch.real(self._crop(ifft2c(fx * y / (torch.abs(fx) + eps))))
        return prox.reshape(b, -1)

    def eq_var(self, var):
        return var * self.big**2 / self.img_dim**2


class HDR(Operator):
    """Saturating dynamic-range compression clip(x / 0.5, -1, 1)
    (nshmc_tpu/operators/nonlinear.py:247-291). Like PhaseRetrieval it holds
    no tensors and runs on the device of its input."""

    def __init__(self, channels: int = 3, img_dim: int = 256, device="cuda"):
        self.channels, self.img_dim = channels, img_dim
        self.device = torch.device(device)

    @classmethod
    def create(cls, channels: int = 3, img_dim: int = 256, device="cuda"):
        return cls(channels, img_dim, device)

    def is_linear(self):
        return False

    def H(self, vec):
        return torch.clamp(vec.reshape(vec.shape[0], -1) / 0.5, -1.0, 1.0)

    def H_pinv(self, vec):
        return vec.reshape(vec.shape[0], -1)

    def proj(self, x_vec, y_vec, alpha_obs: float = 1.0, thre: float = 1.0):
        """Selective replacement prox (nshmc_tpu/operators/nonlinear.py:276-288)."""
        x, y = x_vec, y_vec
        mask1 = (torch.abs(y) >= thre) & (torch.abs(x) < thre / 2)
        if alpha_obs == 1.0:
            mask2 = torch.abs(y) < 1
        else:
            mask2 = torch.abs(y) < thre / 2
        out = torch.where(mask1, y / 2, x)
        return torch.where(mask2, y / 2, out)

    def eq_var(self, var):
        return var / 4
