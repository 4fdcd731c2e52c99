"""The ADM / openaimodel U-Net as plain PyTorch (guided-diffusion's
unet.py, the architecture of DPS's ffhq_10m.pt and of the CompVis LDM's
eps-net), float32 by default.

GroupNorm is `F.group_norm` (32 groups), SiLU is `F.silu`, attention is
QKVAttentionLegacy as matmuls and a float32 softmax, resampling is a 2x2
average pool or a stride-2 conv down and nearest-neighbour up. Parameter
names are the reference checkpoint's keys (input_blocks.{i}.{j},
middle_block.{j}, output_blocks.{i}.{j}, out.{j}, time_embed.{0,2}).

`compute_dtype` runs every convolution and linear layer in that dtype (the
control in bfloat16); `quant` (a callable on tensors) is applied to the
operands of every convolution, linear layer and attention product (the
control in fp8: see control.py)."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class UNetSpec:
    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_ds: Tuple[int, ...]
    channel_mult: Tuple[int, ...]
    num_head_channels: int
    use_scale_shift_norm: bool
    resblock_updown: bool
    conv_resample: bool = True
    eps: float = 1e-5


class Numerics:
    """How the layers compute: the dtype of convolutions, linear layers and
    the activations between them, and an optional rounding of the operands
    of every product."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.dtype = compute_dtype
        self.quant = quant or (lambda t: t)

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation between layers, kept in the compute dtype (GroupNorm
        statistics and softmax are float32 islands)."""
        return t.to(self.dtype)

    def conv(self, layer: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
        w = self.quant(layer.weight.to(self.dtype))
        b = None if layer.bias is None else layer.bias.to(self.dtype)
        fn = F.conv2d if isinstance(layer, nn.Conv2d) else F.conv1d
        return fn(self.quant(x.to(self.dtype)), w, b, stride=layer.stride,
                  padding=layer.padding, **kw)

    def linear(self, layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        w = layer.weight.to(self.dtype)
        if w.dim() > 2:  # a 1x1 convolution used on tokens
            w = w.reshape(w.shape[0], -1)
        b = None if layer.bias is None else layer.bias.to(self.dtype)
        return F.linear(self.quant(x.to(self.dtype)), self.quant(w), b)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.quant(a.to(self.dtype)), self.quant(b.to(self.dtype)))


def gn_silu(norm: nn.GroupNorm, x: torch.Tensor, scale=None, shift=None) -> torch.Tensor:
    """GroupNorm (float32) -> optional h * (1 + scale) + shift -> SiLU."""
    h = F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps)
    if scale is not None:
        h = h * (1 + scale.float()[:, :, None, None]) + shift.float()[:, :, None, None]
    return F.silu(h)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                          device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def conv3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class ResBlock(nn.Module):
    def __init__(self, cin, emb_ch, cout, spec: UNetSpec, up=False, down=False):
        super().__init__()
        self.spec, self.up, self.down = spec, up, down
        self.in_layers = nn.Sequential(nn.GroupNorm(32, cin, spec.eps), nn.SiLU(), conv3(cin, cout))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_ch, 2 * cout if spec.use_scale_shift_norm else cout))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, cout, spec.eps), nn.SiLU(),
                                        nn.Dropout(0.0), conv3(cout, cout))
        self.skip_connection = nn.Identity() if cin == cout else nn.Conv2d(cin, cout, 1)

    def forward(self, x, emb, nm: Numerics):
        h = gn_silu(self.in_layers[0], x)
        if self.up:
            h, x = (F.interpolate(a, scale_factor=2, mode="nearest") for a in (h, x))
        elif self.down:
            h, x = (F.avg_pool2d(a, 2) for a in (h, x))
        h = nm.act(nm.conv(self.in_layers[2], h))
        e = nm.act(nm.linear(self.emb_layers[1], F.silu(emb.float())))
        if self.spec.use_scale_shift_norm:
            scale, shift = e.chunk(2, dim=1)
            h = gn_silu(self.out_layers[0], h, scale, shift)
        else:
            h = gn_silu(self.out_layers[0], h + e[:, :, None, None])
        h = nm.act(nm.conv(self.out_layers[3], h))
        skip = x if isinstance(self.skip_connection, nn.Identity) else \
            nm.act(nm.conv(self.skip_connection, x))
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, channels, head_channels, eps):
        super().__init__()
        self.heads = channels // head_channels
        self.norm = nn.GroupNorm(32, channels, eps)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x, emb, nm: Numerics):
        b, c, hh, ww = x.shape
        t, ch = hh * ww, c // self.heads
        h = nm.act(F.group_norm(x.float(), 32, self.norm.weight, self.norm.bias, self.norm.eps))
        tokens = h.reshape(b, c, t).transpose(1, 2)
        qkv = nm.act(nm.linear(self.qkv, tokens)).reshape(b, t, self.heads, 3, ch)
        q, k, v = (qkv[..., i, :].transpose(1, 2) for i in range(3))  # (b, heads, t, ch)
        s = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.softmax(nm.matmul(q * s, (k * s).transpose(-1, -2)).float(), dim=-1)
        a = nm.act(nm.matmul(w, v)).transpose(1, 2).reshape(b, t, c)
        a = nm.act(nm.linear(self.proj_out, a))
        return x + a.transpose(1, 2).reshape(b, c, hh, ww)


class Down(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = conv3(ch, ch, stride=2)

    def forward(self, x, emb, nm):
        return nm.act(nm.conv(self.op, x))


class Up(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = conv3(ch, ch)

    def forward(self, x, emb, nm):
        return nm.act(nm.conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest")))


class InConv(nn.Conv2d):
    def forward(self, x, emb, nm):
        return nm.act(nm.conv(self, x))


class Seq(nn.ModuleList):
    def forward(self, h, emb, nm):
        for layer in self:
            h = layer(h, emb, nm)
        return h


class UNet(nn.Module):
    """forward(x (B, H, W, C) NHWC, t (B,)) -> (B, H, W, out_channels) float32."""

    def __init__(self, spec: UNetSpec):
        super().__init__()
        self.spec = spec
        self.numerics = Numerics()
        mc, td = spec.model_channels, spec.model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, td), nn.SiLU(), nn.Linear(td, td))

        def res(cin, cout, **kw):
            return ResBlock(cin, td, cout, spec, **kw)

        def attn(c):
            return AttentionBlock(c, spec.num_head_channels, spec.eps)

        ch = spec.channel_mult[0] * mc
        self.input_blocks = nn.ModuleList([Seq([InConv(spec.in_channels, ch, 3, padding=1)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(spec.channel_mult):
            for _ in range(spec.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in spec.attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(Seq(layers))
                chans.append(ch)
            if level != len(spec.channel_mult) - 1:
                self.input_blocks.append(Seq([res(ch, ch, down=True) if spec.resblock_updown
                                              else Down(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Seq([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(spec.channel_mult))):
            for i in range(spec.num_res_blocks + 1):
                layers = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in spec.attention_ds:
                    layers.append(attn(ch))
                if level and i == spec.num_res_blocks:
                    layers.append(res(ch, ch, up=True) if spec.resblock_updown else Up(ch))
                    ds //= 2
                self.output_blocks.append(Seq(layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch, spec.eps), nn.SiLU(),
                                 nn.Conv2d(ch, spec.out_channels, 3, padding=1))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        nm = self.numerics
        emb = timestep_embedding(t, self.spec.model_channels)
        emb = nm.linear(self.time_embed[2], F.silu(nm.linear(self.time_embed[0], emb).float()))
        emb = nm.act(emb)
        h = nm.act(x.permute(0, 3, 1, 2))
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, nm)
            hs.append(h)
        h = self.middle_block(h, emb, nm)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, nm)
        h = nm.conv(self.out[2], gn_silu(self.out[0], h)).float()
        return h.permute(0, 2, 3, 1)
