"""Stable Diffusion 2's conditional U-Net as plain PyTorch (openaimodel.
UNetModel at v2-inference.yaml's settings: no scale-shift norm, conv
resampling, `num_head_channels`-channel heads, a SpatialTransformer
(reference/transformer.py) at every attention site and in the middle
block), float32 by default. Its ResBlocks, resampling and time embedding are
reference/unet.py's; parameter names are the checkpoint's
model.diffusion_model keys."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from .transformer import SpatialTransformer
from .unet import Down, InConv, Numerics, ResBlock, Up, UNetSpec, gn_silu, timestep_embedding


@dataclasses.dataclass(frozen=True)
class SDSpec:
    unet: UNetSpec
    context_dim: int
    depth: int = 1


class Blocks(nn.ModuleList):
    """One unit: ResBlocks and resampling take the embedding, a
    SpatialTransformer the context."""

    def forward(self, h, emb, context, nm: Numerics):
        for layer in self:
            h = layer(h, context, nm) if isinstance(layer, SpatialTransformer) else \
                layer(h, emb, nm)
        return h


class SDUNet(nn.Module):
    """forward(x (B, H, W, C) NHWC, t (B,), context (B, S, context_dim)) ->
    (B, H, W, out_channels) float32."""

    def __init__(self, sd: SDSpec):
        super().__init__()
        spec = sd.unet
        self.spec = spec
        self.numerics = Numerics()
        mc, td = spec.model_channels, spec.model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, td), nn.SiLU(), nn.Linear(td, td))

        def res(cin, cout):
            return ResBlock(cin, td, cout, spec)

        def attn(c):
            return SpatialTransformer(c, c // spec.num_head_channels, spec.num_head_channels,
                                      sd.depth, sd.context_dim)

        ch = spec.channel_mult[0] * mc
        self.input_blocks = nn.ModuleList([Blocks([InConv(spec.in_channels, ch, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(spec.channel_mult):
            for _ in range(spec.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in spec.attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(Blocks(layers))
                chans.append(ch)
            if level != len(spec.channel_mult) - 1:
                self.input_blocks.append(Blocks([Down(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Blocks([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(spec.channel_mult))):
            for i in range(spec.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in spec.attention_ds:
                    layers.append(attn(ch))
                if level and i == spec.num_res_blocks:
                    layers.append(Up(ch))
                    ds //= 2
                self.output_blocks.append(Blocks(layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch, spec.eps), nn.SiLU(),
                                 nn.Conv2d(ch, spec.out_channels, 3, padding=1))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        nm = self.numerics
        emb = timestep_embedding(t, self.spec.model_channels)
        emb = nm.linear(self.time_embed[2], F.silu(nm.linear(self.time_embed[0], emb).float()))
        emb = nm.act(emb)
        ctx = nm.act(context)
        h = nm.act(x.permute(0, 3, 1, 2))
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, ctx, nm)
            hs.append(h)
        h = self.middle_block(h, emb, ctx, nm)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, ctx, nm)
        h = nm.conv(self.out[2], gn_silu(self.out[0], h)).float()
        return h.permute(0, 2, 3, 1)
