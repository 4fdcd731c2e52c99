"""Diagonal Gaussian posterior and EMA parameter averaging (port of
nshmc_tpu/models/ldm/distributions.py).

The KL autoencoder's `encode` returns a DiagonalGaussian over the latent;
`ema_update` is the LitEma step over a name -> tensor mapping (a
`state_dict`). Tensors are NHWC, as everywhere at the port's public
functions, so the moments split along the last axis.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiagonalGaussian(NamedTuple):
    """Posterior from a [mean | logvar] moment tensor (last-axis split)."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor, clip: tuple = (-30.0, 20.0)):
        mean, logvar = torch.chunk(moments, 2, dim=-1)
        return cls(mean, torch.clamp(logvar, *clip))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise, the noise drawn from `generator` unless given."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def _axes(self):
        return tuple(range(1, self.mean.dim()))

    def kl(self, other: "DiagonalGaussian | None" = None) -> torch.Tensor:
        """KL to `other` (or the standard normal), summed over the non-batch
        axes."""
        if other is None:
            return 0.5 * torch.sum(self.mean**2 + self.var - 1.0 - self.logvar, dim=self._axes())
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var - 1.0
            - self.logvar + other.logvar, dim=self._axes())

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=self._axes())


def ema_update(ema_params: dict, params: dict, decay: float = 0.9999) -> dict:
    """One EMA step, ema <- ema - (1 - decay) * (ema - param), over two
    mappings with the same keys."""
    return {k: e - (1.0 - decay) * (e - params[k]) for k, e in ema_params.items()}
