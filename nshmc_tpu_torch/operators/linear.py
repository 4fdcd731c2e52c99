"""Pixel-selection and per-pixel-SVD linear operators (port of
nshmc_tpu/operators/linear.py):
  Inpainting      — index permutation SVD
  Denoising       — identity
  SuperResolution — r x r block averaging, patch SVD
  Colorization    — per-pixel 1x3 averaging SVD

The 1 x r^2 and 1 x 3 SVDs are numpy's, as in the JAX package; the applies
are gathers, reshapes and small matrix products on the operator's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import SVDOperator, host_tensor, pad_zeros, promote


class Inpainting(SVDOperator):
    """Pixel masking. Spectral (V) space orders kept entries first, missing
    last; all singular values are 1 (nshmc_tpu/operators/linear.py:23-99).

    `missing_indices` / `kept_indices` index the pixel-major interleaved
    flattening idx = pixel * channels + channel, the reference's
    `3 * randperm(d^2) + c` construction.
    """

    def __init__(self, channels: int, img_dim: int, missing_indices, device="cuda"):
        missing = np.asarray(missing_indices, np.int64)
        keep_mask = np.ones(channels * img_dim**2, bool)
        keep_mask[missing] = False
        kept = np.nonzero(keep_mask)[0]
        self.channels, self.img_dim = channels, img_dim
        self.missing_indices = torch.as_tensor(missing, device=device)
        self.kept_indices = torch.as_tensor(kept, device=device)

    def _to_pixel_major(self, vec):
        b = vec.shape[0]
        return vec.reshape(b, self.channels, -1).transpose(1, 2).reshape(b, -1)

    def _from_pixel_major(self, vec):
        b = vec.shape[0]
        return vec.reshape(b, -1, self.channels).transpose(1, 2).reshape(b, -1)

    def V(self, vec):
        temp = vec.reshape(vec.shape[0], -1)
        n_kept = self.kept_indices.shape[0]
        out = torch.zeros_like(temp)
        out[:, self.kept_indices] = temp[:, :n_kept]
        out[:, self.missing_indices] = temp[:, n_kept:]
        return self._from_pixel_major(out)

    def Vt(self, vec):
        temp = self._to_pixel_major(vec)
        return torch.cat([temp[:, self.kept_indices], temp[:, self.missing_indices]], dim=1)

    def U(self, vec):
        return vec.reshape(vec.shape[0], -1)

    def Ut(self, vec):
        return vec.reshape(vec.shape[0], -1)

    def singulars(self):
        return torch.ones(self.kept_indices.shape[0], dtype=torch.float32,
                          device=self.kept_indices.device)

    def add_zeros(self, vec):
        out = torch.zeros((vec.shape[0], self.channels * self.img_dim**2),
                          dtype=vec.dtype, device=vec.device)
        out[:, : vec.shape[1]] = vec
        return out


def random_inpainting_indices(generator, img_dim: int, frac_missing: float = 0.92) -> np.ndarray:
    """Random-pixel inpainting mask, every channel of a chosen pixel dropped
    (nshmc_tpu/operators/linear.py:102-112). The permutation comes from
    `generator`, a `torch.Generator` or a numpy `Generator`: the JAX
    function draws it from a threefry key, whose stream torch cannot
    reproduce, so the two masks differ for the same seed. `build_operator`
    draws from a numpy generator in both packages and gives equal masks."""
    n_missing = int(img_dim**2 * frac_missing)
    if isinstance(generator, torch.Generator):
        perm = torch.randperm(img_dim**2, generator=generator).numpy()
    else:
        perm = generator.permutation(img_dim**2)
    missing_r = 3 * perm[:n_missing].astype(np.int64)
    return np.sort(np.concatenate([missing_r, missing_r + 1, missing_r + 2]))


def box_inpainting_indices(img_dim: int, channels: int, left: int, up: int,
                           size: int = 128) -> np.ndarray:
    """Box inpainting: the box region is missing
    (nshmc_tpu/operators/linear.py:115-121)."""
    mask = np.zeros((img_dim, img_dim, channels), np.float32)
    mask[left: left + size, up: up + size, :] = 1.0
    return np.nonzero(mask.reshape(-1))[0].astype(np.int32)


class Denoising(SVDOperator):
    """Identity operator (nshmc_tpu/operators/linear.py:124-147)."""

    def __init__(self, channels: int, img_dim: int, device="cuda"):
        self.channels, self.img_dim = channels, img_dim
        self.device = torch.device(device)

    @classmethod
    def create(cls, channels: int, img_dim: int, device="cuda") -> "Denoising":
        return cls(channels, img_dim, device)

    def V(self, vec):
        return vec.reshape(vec.shape[0], -1)

    Vt = V
    U = V
    Ut = V
    add_zeros = V

    def singulars(self):
        return torch.ones(self.channels * self.img_dim**2, dtype=torch.float32,
                          device=self.device)


class SuperResolution(SVDOperator):
    """r x r block-averaging downsampling through the SVD of the 1 x r^2
    patch kernel (nshmc_tpu/operators/linear.py:150-242). Spectral layout:
    component 0 (the patch mean direction) of all channels * y_dim^2 patches
    first, then components 1..r^2-1, (channel, patch)-major."""

    def __init__(self, u_sign, singulars_small, v_small, channels: int, img_dim: int,
                 ratio: int, device="cuda"):
        self.u_sign = host_tensor(u_sign, device)  # the 1x1 U entry, +-1
        self.singulars_small = host_tensor(singulars_small, device)  # (1,): 1/r
        self.v_small = host_tensor(v_small, device)  # (r^2, r^2)
        self.channels, self.img_dim, self.ratio = channels, img_dim, ratio

    @property
    def y_dim(self):
        return self.img_dim // self.ratio

    @classmethod
    def create(cls, channels: int, img_dim: int, ratio: int,
               device="cuda") -> "SuperResolution":
        if img_dim % ratio:
            raise ValueError(f"img_dim {img_dim} is not a multiple of the ratio {ratio}")
        h = np.full((1, ratio**2), 1.0 / ratio**2)
        u, s, vt = np.linalg.svd(h, full_matrices=True)
        return cls(u[0, 0], s, vt.T, channels, img_dim, ratio, device)

    def _patches_to_spectral(self, patches):
        """(B, C, y^2, r^2) -> (B, D) in the reference's coefficient order."""
        b = patches.shape[0]
        return torch.cat([patches[..., 0].reshape(b, -1), patches[..., 1:].reshape(b, -1)],
                         dim=1)

    def _spectral_to_patches(self, vec):
        b = vec.shape[0]
        c, y2, r2 = self.channels, self.y_dim**2, self.ratio**2
        head = vec[:, : c * y2].reshape(b, c, y2, 1)
        tail = vec[:, c * y2:].reshape(b, c, y2, r2 - 1)
        return torch.cat([head, tail], dim=-1)

    def V(self, vec):
        b = vec.shape[0]
        patches = self._spectral_to_patches(promote(vec.reshape(b, -1), self.v_small))
        patches = patches @ self.v_small.T  # einsum "ij,bcpj->bcpi"
        y, r = self.y_dim, self.ratio
        img = patches.reshape(b, self.channels, y, y, r, r).permute(0, 1, 2, 4, 3, 5)
        return img.reshape(b, -1)

    def Vt(self, vec):
        b = vec.shape[0]
        y, r = self.y_dim, self.ratio
        img = promote(vec, self.v_small).reshape(b, self.channels, y, r, y, r)
        patches = img.permute(0, 1, 2, 4, 3, 5).reshape(b, self.channels, y * y, r * r)
        return self._patches_to_spectral(patches @ self.v_small)  # einsum "ji,bcpj->bcpi"

    def U(self, vec):
        return self.u_sign * vec.reshape(vec.shape[0], -1)

    Ut = U  # U is 1x1, so U^T = U

    def singulars(self):
        # jnp.tile: the one patch singular value for each of c * y^2 patches
        return self.singulars_small.repeat(self.channels * self.y_dim**2)

    def add_zeros(self, vec):
        return pad_zeros(vec, vec.shape[1] * self.ratio**2)


class Colorization(SVDOperator):
    """Grayscale observation: per-pixel 1x3 channel-averaging SVD
    (nshmc_tpu/operators/linear.py:245-299). Spectral layout is
    component-major: component 0 of every pixel first, then 1..2."""

    channels = 3

    def __init__(self, u_sign, singular0, v_small, img_dim: int, device="cuda"):
        self.u_sign = host_tensor(u_sign, device)
        self.singular0 = host_tensor(singular0, device)  # the nonzero singular value
        self.v_small = host_tensor(v_small, device)  # (3, 3)
        self.img_dim = img_dim

    @classmethod
    def create(cls, img_dim: int, device="cuda") -> "Colorization":
        h = np.asarray([[0.3333, 0.3334, 0.3333]])
        u, s, vt = np.linalg.svd(h, full_matrices=True)
        return cls(u[0, 0], s[0], vt.T, img_dim, device)

    def _needles(self, vec):
        """(B, 3 * P) -> (B, P, 3)."""
        return promote(vec, self.v_small).reshape(vec.shape[0], 3, -1).transpose(1, 2)

    def V(self, vec):
        out = self._needles(vec) @ self.v_small.T  # einsum "ij,bpj->bpi"
        return out.transpose(1, 2).reshape(vec.shape[0], -1)

    def Vt(self, vec):
        out = self._needles(vec) @ self.v_small  # einsum "ji,bpj->bpi"
        return out.transpose(1, 2).reshape(vec.shape[0], -1)

    def U(self, vec):
        return self.u_sign * vec.reshape(vec.shape[0], -1)

    Ut = U

    def singulars(self):
        return self.singular0.expand(self.img_dim**2)

    def add_zeros(self, vec):
        return pad_zeros(vec, 3 * self.img_dim**2)
