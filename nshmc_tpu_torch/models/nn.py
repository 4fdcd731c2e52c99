"""Shared NN primitives for the ADM U-Net (port of nshmc_tpu/models/nn.py).

Layout: the U-Net's public tensors are NHWC, as in the JAX package; inside,
activations are NCHW tensors in `torch.channels_last` memory, so cuDNN's
convolutions and the GroupNorm kernel both see rows of C contiguous
channels, and `x.permute(0, 2, 3, 1)` is the (free) NHWC view.

Norms reduce in float32 islands whatever the activation dtype, in the
per-channel-sums form of `ChanStatsGroupNorm` (nshmc_tpu/models/nn.py:53-102):
per-channel fp32 sums, a (B, groups) combine with var = max(E[x^2] -
E[x]^2, 0), eps 1e-5 (1e-6 in the VQ autoencoder), output cast back to the
activation dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.groupnorm import group_moments, group_stats, groupnorm_silu

NUM_GROUPS = 32
EPS = 1e-5


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order
    (nshmc_tpu/models/nn.py:29-40). timesteps: (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels_last) -> NHWC view."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels_last when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


class _GroupStats(torch.autograd.Function):
    """(mean_c, inv_c), each (B, C) fp32, of x: (B, R, C) by `group_stats`
    (K2a's one launch on the card, its plain version on the CPU). The
    backward is their closed-form gradient in plain torch, as JAX
    differentiates `ChanStatsGroupNorm` in XLA: with n = R * C / groups,
    d mean / dx = 1 / n and d inv / dx = -inv^3 (x - mean) / n, the latter
    0 where the variance clip is active (E[x^2] - mean^2 < 0)."""

    @staticmethod
    def forward(ctx, x, num_groups, eps):
        sums, mean_c, inv_c = group_stats(x.contiguous(), num_groups, eps)
        ctx.save_for_backward(x, sums, mean_c, inv_c)
        ctx.num_groups = num_groups
        return mean_c, inv_c

    @staticmethod
    def backward(ctx, g_mean, g_inv):
        x, sums, mean_c, inv_c = ctx.saved_tensors
        b, r, c = x.shape
        cg = c // ctx.num_groups
        n = r * cg
        _, var = group_moments(sums, r, ctx.num_groups)
        inv = inv_c[:, ::cg]
        gm = g_mean.reshape(b, ctx.num_groups, cg).sum(-1) / n
        gi = g_inv.reshape(b, ctx.num_groups, cg).sum(-1) * inv**3 * (var >= 0) / n
        gm, gi = (t.repeat_interleave(cg, dim=1)[:, None] for t in (gm, gi))
        dx = gm - gi * (x.float() - mean_c[:, None])
        return dx.to(x.dtype), None, None


class GroupNorm32(nn.Module):
    """GroupNorm(32) in an fp32 island, ChanStatsGroupNorm form, no
    activation: the AttentionBlock's `norm` (nshmc_tpu/models/unet.py:212;
    eps 1e-6 in the VQ autoencoder's AttnBlock). Parameter names match the
    reference's GroupNorm32 (weight, bias). The statistics come from
    `group_stats` through `_GroupStats`; the affine after them is plain
    torch, as in JAX."""

    def __init__(self, channels: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x3 = nhwc(x).reshape(b, h * w, c)
        mean_c, inv_c = _GroupStats.apply(x3, NUM_GROUPS, self.eps)
        y = (x3.float() - mean_c[:, None]) * inv_c[:, None] * self.weight + self.bias
        return nchw(y.to(x.dtype).reshape(b, h, w, c))


class GroupNormSiLU(nn.Module):
    """GroupNorm(32, fp32 stats) -> affine -> SiLU through the fused kernel
    (ops/groupnorm.py). With (scale, shift) — the scale-shift `out_norm`,
    nshmc_tpu/models/unet.py:170-177 — the affine becomes per (batch,
    channel): weight * (1 + scale) and bias * (1 + scale) + shift. eps is
    1e-5 in the U-Net, 1e-6 in the VQ autoencoder (nshmc_tpu/models/ldm/
    autoencoder.py:32-41). Parameter names match the reference's GroupNorm32
    (weight, bias)."""

    def __init__(self, channels: int, eps: float = EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, scale: torch.Tensor | None = None,
                shift: torch.Tensor | None = None) -> torch.Tensor:
        weight, bias = self.weight.float(), self.bias.float()
        if scale is not None:
            s = 1.0 + scale.float()
            weight, bias = weight * s, bias * s + shift.float()
        return nchw(groupnorm_silu(nhwc(x), weight, bias, NUM_GROUPS, self.eps))


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of an NCHW (channels_last) tensor
    (nshmc_tpu/models/nn.py:152)."""
    b, c, h, w = x.shape
    return nchw(nhwc(x).reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4)))


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW (channels_last) tensor
    (nshmc_tpu/models/nn.py:157)."""
    b, c, h, w = x.shape
    y = nhwc(x)[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return nchw(y.reshape(b, 2 * h, 2 * w, c))
