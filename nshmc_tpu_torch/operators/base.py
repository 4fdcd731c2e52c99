"""Matrix-free SVD forward-operator interface (port of
nshmc_tpu/operators/base.py).

Vectors are flat (batch, dim) tensors flattened from channel-first
(B, C, H, W) images, as in the reference; images elsewhere are NHWC, and
`flatten_image` / `unflatten_image` convert at the boundary.
"""
from __future__ import annotations

import torch


def flatten_image(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C*H*W) in channel-first order."""
    return x_nhwc.permute(0, 3, 1, 2).reshape(x_nhwc.shape[0], -1)


def unflatten_image(vec: torch.Tensor, channels: int, img_dim: int) -> torch.Tensor:
    """(B, C*H*W) channel-first flat -> (B, H, W, C)."""
    return vec.reshape(vec.shape[0], channels, img_dim, img_dim).permute(0, 2, 3, 1)


class SVDOperator:
    """Operator with a matrix-free SVD H = U S V^T. Subclasses provide
    V/Vt/U/Ut/singulars/add_zeros and the `channels` / `img_dim` shape
    metadata; the composite maps follow nshmc_tpu/operators/base.py:95-110."""

    channels: int
    img_dim: int

    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self) -> torch.Tensor:
        raise NotImplementedError

    def add_zeros(self, vec):
        raise NotImplementedError

    def H(self, vec: torch.Tensor) -> torch.Tensor:
        temp = self.Vt(vec)
        s = self.singulars()
        return self.U(s * temp[:, : s.shape[0]])

    def Ht(self, vec: torch.Tensor) -> torch.Tensor:
        temp = self.Ut(vec)
        s = self.singulars()
        return self.V(self.add_zeros(s * temp[:, : s.shape[0]]))

    def H_pinv(self, vec: torch.Tensor) -> torch.Tensor:
        temp = self.Ut(vec)
        s = self.singulars()
        s_inv = torch.where(s != 0, 1.0 / torch.where(s != 0, s, torch.ones_like(s)),
                            torch.zeros_like(s))
        temp = torch.cat([temp[:, : s.shape[0]] * s_inv, temp[:, s.shape[0]:]], dim=1)
        return self.V(self.add_zeros(temp))

    def H_img(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """Forward operator on an NHWC image batch -> (B, d_y)."""
        return self.H(flatten_image(x_nhwc))

    def H_pinv_img(self, y: torch.Tensor) -> torch.Tensor:
        """Pseudo-inverse back to NHWC image space."""
        return unflatten_image(self.H_pinv(y), self.channels, self.img_dim)
