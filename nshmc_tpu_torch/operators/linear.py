"""Pixel-selection inpainting operator (port of the `Inpainting` and
`box_inpainting_indices` parts of nshmc_tpu/operators/linear.py)."""
from __future__ import annotations

import numpy as np
import torch

from .base import SVDOperator


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


def box_inpainting_indices(img_dim: int, channels: int, left: int, up: int,
                           size: int = 128) -> np.ndarray:
    """Box inpainting: the box region is missing
    (nshmc_tpu/operators/linear.py:115-121)."""
    mask = np.zeros((img_dim, img_dim, channels), np.float32)
    mask[left: left + size, up: up + size, :] = 1.0
    return np.nonzero(mask.reshape(-1))[0].astype(np.int32)
