"""Explicit-matrix SVD operator (port of nshmc_tpu/operators/general.py):
any dense H gets a host-side numpy SVD and matrix applies on the device.
The tests use it as ground truth for the structured operators."""
from __future__ import annotations

import numpy as np

from .base import SVDOperator, host_tensor, pad_zeros, promote


class GeneralH(SVDOperator):
    """Arbitrary dense measurement matrix H (m x n), SVD'd at construction."""

    def __init__(self, u_mat, v_mat, sing, channels: int = 0, img_dim: int = 0,
                 device="cuda"):
        self.u_mat = host_tensor(u_mat, device)  # (m, m)
        self.v_mat = host_tensor(v_mat, device)  # (n, n)
        self.sing = host_tensor(sing, device)  # (min(m, n),)
        self.channels, self.img_dim = channels, img_dim

    @classmethod
    def create(cls, h_mat, channels: int = 0, img_dim: int = 0, device="cuda") -> "GeneralH":
        u, s, vt = np.linalg.svd(np.asarray(h_mat, np.float64), full_matrices=True)
        return cls(u, vt.T, s, channels, img_dim, device)

    @staticmethod
    def _flat(vec, mat):
        return promote(vec.reshape(vec.shape[0], -1), mat)

    def V(self, vec):
        return self._flat(vec, self.v_mat) @ self.v_mat.T

    def Vt(self, vec):
        return self._flat(vec, self.v_mat) @ self.v_mat

    def U(self, vec):
        return self._flat(vec, self.u_mat) @ self.u_mat.T

    def Ut(self, vec):
        return self._flat(vec, self.u_mat) @ self.u_mat

    def singulars(self):
        return self.sing

    def add_zeros(self, vec):
        return pad_zeros(vec, self.v_mat.shape[0])
