"""Matrix-free SVD forward-operator interface (port of
nshmc_tpu/operators/base.py).

Vectors are flat (batch, dim) tensors flattened from channel-first
(B, C, H, W) images, as in the reference; images elsewhere are NHWC, and
`flatten_image` / `unflatten_image` convert at the boundary.

Operators hold their index maps and small factors as tensors on the device
they were built on (`device`, default `cuda`); the host-side construction
(numpy index maps, numpy SVDs) runs once in `create`. Index tensors are
int64, factors float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def flatten_image(x_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C*H*W) in channel-first order."""
    return x_nhwc.permute(0, 3, 1, 2).reshape(x_nhwc.shape[0], -1)


def unflatten_image(vec: torch.Tensor, channels: int, img_dim: int) -> torch.Tensor:
    """(B, C*H*W) channel-first flat -> (B, H, W, C)."""
    return vec.reshape(vec.shape[0], channels, img_dim, img_dim).permute(0, 2, 3, 1)


def host_tensor(a, device, dtype=None) -> torch.Tensor:
    """A host-built numpy array on `device`: float32 for floats, int64 for
    integers unless `dtype` says otherwise."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


def promote(vec: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """`vec` in the type a product with `factor` computes in (JAX promotes a
    bf16 operand of an f32 einsum to f32; torch's matmul needs one type)."""
    return vec.to(torch.promote_types(vec.dtype, factor.dtype))


def pad_zeros(vec: torch.Tensor, total: int) -> torch.Tensor:
    """(B, n) -> (B, total): `vec` followed by zeros."""
    vec = vec.reshape(vec.shape[0], -1)
    return F.pad(vec, (0, total - vec.shape[1]))


def scale_head(vec: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Multiply the first scale.shape[0] entries of each row by `scale`
    (JAX's `vec.at[:, :n].multiply(scale)`), out of place."""
    n = scale.shape[0]
    return torch.cat([vec[:, :n] * scale, vec[:, n:]], dim=1)


class Operator:
    """Base forward operator: y = H(x) (+ noise). Nonlinear operators
    override `H` / `H_pinv` / `is_linear` (nshmc_tpu/operators/base.py:36-68).
    Subclasses set the `channels` / `img_dim` shape metadata."""

    channels: int
    img_dim: int

    def H(self, vec: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def H_pinv(self, vec: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def is_linear(self) -> bool:
        return True

    def H_img(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """Forward operator on an NHWC image batch -> (B, d_y)."""
        return self.H(flatten_image(x_nhwc))

    def H_pinv_img(self, y: torch.Tensor) -> torch.Tensor:
        """Pseudo-inverse back to NHWC image space."""
        return unflatten_image(self.H_pinv(y), self.channels, self.img_dim)


class SVDOperator(Operator):
    """Operator with a matrix-free SVD H = U S V^T. Subclasses provide
    V/Vt/U/Ut/singulars/add_zeros; the composite maps follow
    nshmc_tpu/operators/base.py:95-131."""

    def V(self, vec):
        raise NotImplementedError

    def Vt(self, vec):
        raise NotImplementedError

    def U(self, vec):
        raise NotImplementedError

    def Ut(self, vec):
        raise NotImplementedError

    def singulars(self) -> torch.Tensor:
        """Singular values, shape (rank_dim,): the small dimension."""
        raise NotImplementedError

    def add_zeros(self, vec):
        """Pad a small-dimension vector with trailing zeros to the big one."""
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
        nonzero = s != 0
        s_inv = torch.where(nonzero, 1.0 / torch.where(nonzero, s, torch.ones_like(s)),
                            torch.zeros_like(s))
        return self.V(self.add_zeros(scale_head(temp, s_inv)))

    def H_scaled_inv(self, vec: torch.Tensor, scale) -> torch.Tensor:
        """(H H^T + scale^2 I)^{-1} in U-space, for PiGDM
        (nshmc_tpu/operators/base.py:112-118)."""
        temp = self.Ut(vec)
        s = self.singulars()
        return scale_head(temp, 1.0 / (s**2 + scale**2))

    def H_dmps_guidance(self, vec, y, at, sigma_y) -> torch.Tensor:
        """Closed-form pseudo-likelihood score for DMPS
        (nshmc_tpu/operators/base.py:120-131). Where sigma_y and a singular
        value are both 0 the rescale is 0, not 1/0."""
        at = torch.as_tensor(at, dtype=torch.float32, device=vec.device)
        sigma_y = torch.as_tensor(sigma_y, dtype=torch.float32, device=vec.device)
        temp = self.Ut(y - self.H(vec) / torch.sqrt(at))
        s = self.singulars()
        rescale = 1.0 / ((1 - at) / at * s**2 + sigma_y**2)
        rescale = torch.where((sigma_y == 0) & (s == 0), torch.zeros_like(rescale), rescale)
        return self.V(self.add_zeros(scale_head(temp, rescale * s))) / torch.sqrt(at)
