"""Walsh-Hadamard compressive sensing operator (port of
nshmc_tpu/operators/cs.py): the fast transform as a log2(n) ladder of
reshapes and stacks over the last axis, orthonormal and self-inverse with
the reference's 1/img_dim scaling."""
from __future__ import annotations

import numpy as np
import torch

from .base import SVDOperator, host_tensor, pad_zeros


def fwht(a: torch.Tensor, scale: float) -> torch.Tensor:
    """Fast Walsh-Hadamard transform over the last axis (a power-of-2
    length), multiplied by `scale` (nshmc_tpu/operators/cs.py:18-31)."""
    n = a.shape[-1]
    if n & (n - 1):
        raise ValueError(f"FWHT length {n} is not a power of 2")
    h = 1
    while h < n:
        x = a.reshape(a.shape[:-1] + (-1, 2, h))
        lo = x[..., 0, :] + x[..., 1, :]
        hi = x[..., 0, :] - x[..., 1, :]
        a = torch.stack([lo, hi], dim=-2).reshape(a.shape)
        h *= 2
    return a * scale


class WalshHadamardCS(SVDOperator):
    """Subsampled Walsh-Hadamard measurement: keep the first D/ratio permuted
    Hadamard coefficients, all singular values 1; pixel-major spectral
    layout (nshmc_tpu/operators/cs.py:34-92)."""

    def __init__(self, perm, inv_perm, channels: int, img_dim: int, ratio: int,
                 device="cuda"):
        self.perm = host_tensor(perm, device)  # (d^2,) Hadamard coefficient order
        self.inv_perm = host_tensor(inv_perm, device)
        self.channels, self.img_dim, self.ratio = channels, img_dim, ratio

    @classmethod
    def create(cls, channels: int, img_dim: int, ratio: int, perm,
               device="cuda") -> "WalshHadamardCS":
        perm = np.asarray(perm, np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        return cls(perm, inv, channels, img_dim, ratio, device)

    def _fwht(self, img):
        return fwht(img, 1.0 / self.img_dim)

    def V(self, vec):
        b = vec.shape[0]
        coeffs = vec.reshape(b, -1, self.channels).transpose(1, 2)[:, :, self.inv_perm]
        return self._fwht(coeffs).reshape(b, -1)

    def Vt(self, vec):
        b = vec.shape[0]
        coeffs = self._fwht(vec.reshape(b, self.channels, -1))[:, :, self.perm]
        return coeffs.transpose(1, 2).reshape(b, -1)

    def U(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return torch.ones(self.channels * self.img_dim**2 // self.ratio, dtype=torch.float32,
                          device=self.perm.device)

    def add_zeros(self, vec):
        return pad_zeros(vec, self.channels * self.img_dim**2)
