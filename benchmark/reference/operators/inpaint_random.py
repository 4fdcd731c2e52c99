"""Random inpainting as in DDRM / DPS: a share `missing_share` of the pixels
(every channel of each) is missing; H keeps the others, in pixel-major order
(pixel * channels + channel, ascending)."""
from __future__ import annotations

import numpy as np
import torch


def kept_indices(rng: np.random.Generator, img_dim: int, channels: int,
                 missing_share: float) -> np.ndarray:
    """The kept flat indices when `rng` draws the missing pixels as a
    permutation of the img_dim^2 pixels cut to its first share."""
    perm = rng.permutation(img_dim ** 2)[: int(img_dim ** 2 * missing_share)]
    keep = np.ones(img_dim ** 2 * channels, bool)
    for c in range(channels):
        keep[channels * perm + c] = False
    return np.nonzero(keep)[0]


class Operator:
    def __init__(self, traffic: dict, data: dict, rng: np.random.Generator, device):
        self.kept = torch.as_tensor(kept_indices(rng, data["image_size"], data["channels"],
                                                 traffic["missing_share"]), device=device)
        self.d_y = int(self.kept.numel())

    def H(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return x_nhwc.reshape(x_nhwc.shape[0], -1)[:, self.kept]
