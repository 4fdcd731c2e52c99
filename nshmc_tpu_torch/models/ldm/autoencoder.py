"""VQ-f4 autoencoder, the latent path's first stage (port of
nshmc_tpu/models/ldm/autoencoder.py).

  - Parameter names are the reference checkpoint's keys (encoder.down.{i}.
    block.{j}.norm1, decoder.mid.attn_1.q, decoder.up.{i}.upsample.conv,
    quantize.embedding, quant_conv, ...: the enumeration of
    models/ldm/port.py::ae_param_mapping), with the checkpoint's shapes, so a
    reference first stage loads with `load_state_dict(strict=True)`.
  - Public tensors are NHWC and come out in float32, as the U-Net's; inside,
    activations are NCHW in `torch.channels_last` memory (models/nn.py).
  - Every norm -> SiLU pair (norm1, norm2, norm_out) goes through the
    GroupNorm+SiLU kernels (ops/groupnorm.py) with eps 1e-6; the AttnBlock's
    `norm` has no SiLU after it and stays plain torch in fp32.
  - AEAttnBlock is single-head attention over all tokens (T = 4096, C = 512
    in the flagship decoder's mid block): plain matmuls and an fp32 softmax,
    logits scaled by C^-1/2 after the product, as the JAX package's einsums
    (nshmc_tpu/models/ldm/autoencoder.py:80-101). It does not go through the
    attention kernel, whose legacy pre-scaling rounds elsewhere.
  - VectorQuantizer: nearest codebook entry by ||z||^2 - 2 z.c + ||c||^2 in
    fp32, with a straight-through gradient (z + (z_q - z).detach()).
  - Conv weights are stored in the compute dtype, GroupNorm parameters and
    the codebook in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import GroupNorm32, GroupNormSiLU, nchw, nearest_upsample_2x, nhwc
from .distributions import DiagonalGaussian

AE_EPS = 1e-6  # the reference's Normalize (ldm/modules/diffusionmodules/model.py:37-39)


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 3
    embed_dim: int = 3
    n_embed: int = 8192
    resolution: int = 256
    attn_resolutions: Tuple[int, ...] = ()
    double_z: bool = False


def _conv(cin: int, cout: int, kernel: int = 3, stride: int = 1,
          padding: Optional[int] = None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=kernel // 2 if padding is None else padding)


def _to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Conv weights in the compute dtype and channels_last; norms and the
    codebook stay fp32."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype=dtype, memory_format=torch.channels_last)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv of the stage's dtype on an NHWC tensor -> NHWC float32."""
    return nhwc(conv(nchw(x).to(conv.weight.dtype))).float()


class AEResnetBlock(nn.Module):
    """norm1 -> SiLU -> conv1 -> norm2 -> SiLU -> conv2, plus the input
    (through a 1x1 nin_shortcut where the width changes)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, eps=AE_EPS)
        self.conv1 = _conv(in_channels, out_channels)
        self.norm2 = GroupNormSiLU(out_channels, eps=AE_EPS)
        self.conv2 = _conv(out_channels, out_channels)
        self.nin_shortcut = (_conv(in_channels, out_channels, kernel=1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AEAttnBlock(nn.Module):
    """Single-head spatial attention: 1x1 q/k/v, logits q.k scaled by C^-1/2,
    softmax in fp32, weights cast to v's dtype, 1x1 proj_out."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=AE_EPS)
        self.q = _conv(channels, channels, kernel=1)
        self.k = _conv(channels, channels, kernel=1)
        self.v = _conv(channels, channels, kernel=1)
        self.proj_out = _conv(channels, channels, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = nhwc(self.norm(x)).reshape(b, hh * ww, c)
        q, k, v = (F.linear(h, m.weight[:, :, 0, 0], m.bias) for m in (self.q, self.k, self.v))
        w = torch.bmm(q, k.transpose(1, 2)) * (c ** -0.5)
        w = torch.softmax(w.float(), dim=-1).to(v.dtype)
        a = F.linear(torch.bmm(w, v), self.proj_out.weight[:, :, 0, 0], self.proj_out.bias)
        return x + nchw(a.view(b, hh, ww, c))


class AEDownsample(nn.Module):
    """Stride-2 3x3 conv after a (0, 1) pad of the bottom and right edges."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=torch.channels_last)
        return self.conv(x)


class AEUpsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


def _level() -> nn.Module:
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(), nn.ModuleList()
    return level


def _run_level(level: nn.Module, h: torch.Tensor) -> torch.Tensor:
    for j, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[j](h)
    return h


def _mid(channels: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = AEResnetBlock(channels, channels)
    mid.attn_1 = AEAttnBlock(channels)
    mid.block_2 = AEResnetBlock(channels, channels)
    return mid


class Encoder(nn.Module):
    """forward(x): (B, H, W, in_channels) NHWC -> (B, H/f, W/f, z or 2z)
    float32, f = 2^(len(ch_mult) - 1)."""

    def __init__(self, cfg: AutoencoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_in = _conv(cfg.in_channels, cfg.ch)
        curr_res, block_in = cfg.resolution, cfg.ch
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = _level()
            for _ in range(cfg.num_res_blocks):
                level.block.append(AEResnetBlock(block_in, cfg.ch * mult))
                block_in = cfg.ch * mult
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AEAttnBlock(block_in))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = AEDownsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in)
        self.norm_out = GroupNormSiLU(block_in, eps=AE_EPS)
        self.conv_out = _conv(block_in, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)
        _to_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(nchw(x).to(self.dtype))
        for level in self.down:
            h = _run_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return nhwc(self.conv_out(self.norm_out(h))).float()


class Decoder(nn.Module):
    """forward(z): (B, h, w, z_channels) NHWC -> (B, h f, w f, out_ch)
    float32."""

    def __init__(self, cfg: AutoencoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (len(cfg.ch_mult) - 1)
        self.conv_in = _conv(cfg.z_channels, block_in)
        self.mid = _mid(block_in)
        levels = []  # built from the deepest level up, indexed by level
        for i in reversed(range(len(cfg.ch_mult))):
            level = _level()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(AEResnetBlock(block_in, cfg.ch * cfg.ch_mult[i]))
                block_in = cfg.ch * cfg.ch_mult[i]
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AEAttnBlock(block_in))
            if i != 0:
                level.upsample = AEUpsample(block_in)
                curr_res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNormSiLU(block_in, eps=AE_EPS)
        self.conv_out = _conv(block_in, cfg.out_ch)
        _to_compute_dtype(self, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(nchw(z).to(self.dtype))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return nhwc(self.conv_out(self.norm_out(h))).float()


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook lookup with a straight-through gradient."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_embed, 1.0 / n_embed)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """(..., embed_dim) -> flat codebook indices, argmin of
        ||z||^2 - 2 z.c + ||c||^2 in fp32."""
        cb = self.embedding.weight.float()
        flat = z.detach().reshape(-1, cb.shape[1]).float()
        d = (torch.sum(flat**2, dim=1, keepdim=True) - 2 * flat @ cb.T
             + torch.sum(cb**2, dim=1)[None])
        return torch.argmin(d, dim=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z_q = self.embedding.weight[self.indices(z)].reshape(z.shape).to(z.dtype)
        return z + (z_q - z).detach()


class VQModel(nn.Module):
    """The VQ first stage: encode does not quantize, decode does unless
    `force_not_quantize` (the reference's VQModelInterface)."""

    def __init__(self, cfg: AutoencoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)
        self.quant_conv = _conv(cfg.z_channels, cfg.embed_dim, kernel=1)
        self.post_quant_conv = _conv(cfg.embed_dim, cfg.z_channels, kernel=1)
        _to_compute_dtype(self, dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.quant_conv, self.encoder(x))

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:
        quant = h if force_not_quantize else self.quantize(h)
        return self.decoder(_conv_nhwc(self.post_quant_conv, quant))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class AutoencoderKL(nn.Module):
    """KL-regularised first stage: encode returns a DiagonalGaussian over the
    latent, decode is plain. Needs an AutoencoderConfig with double_z."""

    def __init__(self, cfg: AutoencoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if not cfg.double_z:
            raise ValueError("AutoencoderKL requires double_z=True")
        self.cfg = cfg
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quant_conv = _conv(2 * cfg.z_channels, 2 * cfg.embed_dim, kernel=1)
        self.post_quant_conv = _conv(cfg.embed_dim, cfg.z_channels, kernel=1)
        _to_compute_dtype(self, dtype)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_moments(_conv_nhwc(self.quant_conv, self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(_conv_nhwc(self.post_quant_conv, z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.decode(self.encode(x).sample(generator, noise))
