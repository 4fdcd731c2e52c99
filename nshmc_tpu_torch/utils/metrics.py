"""Image quality metrics: PSNR and SSIM (port of nshmc_tpu/utils/metrics.py).

Both take [0, 1]-range NHWC batches and return one value per batch element.
SSIM matches skimage.metrics.structural_similarity's defaults: uniform 7x7
window, K1=0.01, K2=0.03, sample covariance, 'valid' crop, channel mean.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """10 log10(1 / mse) over all axes but the batch axis (data range 1)."""
    mse = ((a - b) ** 2).reshape(a.shape[0], -1).mean(dim=1)
    return 10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Mean filter over the spatial dims of (B, H, W, C), 'valid' padding."""
    b, h, w, c = x.shape
    xt = x.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)
    kernel = torch.full((1, 1, size, size), 1.0 / (size * size), dtype=x.dtype,
                        device=x.device)
    out = F.conv2d(xt, kernel)
    return out.reshape(b, c, out.shape[2], out.shape[3]).permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity per batch element."""
    a, b = a.float(), b.float()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    n = win_size**2
    cov_norm = n / (n - 1)
    ux, uy = _uniform_filter(a, win_size), _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


class RunningStats:
    """Host-side running mean / across-sample std accumulator
    (nshmc_tpu/utils/metrics.py:69-97)."""

    def __init__(self):
        self.sums = {}
        self.stds = {}
        self.n = 0

    def update(self, per_sample_values: dict):
        """name -> per-sample values of one image's sample stack."""
        self.n += 1
        for k, v in per_sample_values.items():
            v = np.asarray(v, np.float64)
            self.sums[k] = self.sums.get(k, 0.0) + float(v.mean())
            if v.size > 1:
                self.stds[k] = self.stds.get(k, 0.0) + float(v.std(ddof=1))

    @classmethod
    def merged(cls, parts) -> "RunningStats":
        """One accumulator over the images of every one of `parts` (the
        processes' of a multi-process run)."""
        out = cls()
        for p in parts:
            out.n += p.n
            for mine, theirs in ((out.sums, p.sums), (out.stds, p.stds)):
                for k, v in theirs.items():
                    mine[k] = mine.get(k, 0.0) + v
        return out

    def summary(self) -> dict:
        out = {}
        for k, s in self.sums.items():
            out[k] = s / max(self.n, 1)
            if k in self.stds:
                out[f"{k}_std"] = self.stds[k] / max(self.n, 1)
        return out
