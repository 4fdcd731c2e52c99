"""The VQ-f4 first stage's decode path as plain PyTorch (taming-transformers'
VectorQuantizer and the CompVis LDM's Decoder, ldm/modules/diffusionmodules/
model.py), float32 by default: nearest codebook entry by ||z||^2 - 2 z.c +
||c||^2 with a straight-through gradient, post_quant_conv, then conv_in, the
mid block (ResnetBlock, single-head AttnBlock, ResnetBlock), the up levels
(num_res_blocks + 1 ResnetBlocks, nearest 2x upsample + conv), norm_out,
SiLU, conv_out. GroupNorm eps 1e-6. Parameter names are the checkpoint's
first_stage_model keys (decoder.*, quantize.embedding, post_quant_conv)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .unet import Numerics

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VQSpec:
    ch: int
    ch_mult: Tuple[int, ...]
    num_res_blocks: int
    z_channels: int
    embed_dim: int
    n_embed: int
    out_ch: int = 3


def norm(c):
    return nn.GroupNorm(32, c, EPS)


def conv(cin, cout, k=3):
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = norm(cin), conv(cin, cout)
        self.norm2, self.conv2 = norm(cout), conv(cout, cout)
        if cin != cout:
            self.nin_shortcut = conv(cin, cout, 1)

    def forward(self, x, nm: Numerics):
        h = nm.act(nm.conv(self.conv1, F.silu(self.norm1(x.float()))))
        h = nm.act(nm.conv(self.conv2, F.silu(self.norm2(h.float()))))
        if hasattr(self, "nin_shortcut"):
            x = nm.act(nm.conv(self.nin_shortcut, x))
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = norm(c)
        self.q, self.k, self.v, self.proj_out = (conv(c, c, 1) for _ in range(4))

    def forward(self, x, nm: Numerics):
        b, c, hh, ww = x.shape
        h = self.norm(x.float()).reshape(b, c, hh * ww).transpose(1, 2)
        q, k, v = (nm.act(nm.linear(m, h)) for m in (self.q, self.k, self.v))
        w = torch.softmax(nm.matmul(q, k.transpose(1, 2)).float() * c ** -0.5, dim=-1)
        a = nm.act(nm.linear(self.proj_out, nm.act(nm.matmul(w, v))))
        return x + a.transpose(1, 2).reshape(b, c, hh, ww)


class Level(nn.Module):
    pass


class Decoder(nn.Module):
    def __init__(self, spec: VQSpec):
        super().__init__()
        block_in = spec.ch * spec.ch_mult[-1]
        self.conv_in = conv(spec.z_channels, block_in)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        levels = []
        for i in reversed(range(len(spec.ch_mult))):
            level = Level()
            level.block = nn.ModuleList()
            for _ in range(spec.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, spec.ch * spec.ch_mult[i]))
                block_in = spec.ch * spec.ch_mult[i]
            if i != 0:
                level.upsample = nn.Module()
                level.upsample.conv = conv(block_in, block_in)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = norm(block_in)
        self.conv_out = conv(block_in, spec.out_ch)

    def forward(self, z, nm: Numerics):
        h = nm.act(nm.conv(self.conv_in, z))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, nm), nm), nm)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, nm)
            if hasattr(level, "upsample"):
                h = nm.act(nm.conv(level.upsample.conv,
                                   F.interpolate(h, scale_factor=2, mode="nearest")))
        return nm.conv(self.conv_out, F.silu(self.norm_out(h.float()))).float()


class VQDecode(nn.Module):
    """decode(z (B, h, w, embed_dim) NHWC) -> image (B, 4h, 4w, 3) NHWC
    float32, differentiable in z through the straight-through quantizer."""

    def __init__(self, spec: VQSpec):
        super().__init__()
        self.numerics = Numerics()
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Embedding(spec.n_embed, spec.embed_dim)
        self.post_quant_conv = conv(spec.embed_dim, spec.z_channels, 1)
        self.decoder = Decoder(spec)
        self.requires_grad_(False)

    def quantized(self, z: torch.Tensor) -> torch.Tensor:
        cb = self.quantize.embedding.weight.float()
        flat = z.detach().reshape(-1, cb.shape[1]).float()
        d = (flat ** 2).sum(1, keepdim=True) - 2 * flat @ cb.T + (cb ** 2).sum(1)[None]
        zq = cb[torch.argmin(d, dim=1)].reshape(z.shape)
        return z + (zq - z).detach()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        nm = self.numerics
        h = self.quantized(z).permute(0, 3, 1, 2)
        h = nm.act(nm.conv(self.post_quant_conv, h))
        return self.decoder(h, nm).permute(0, 2, 3, 1)
