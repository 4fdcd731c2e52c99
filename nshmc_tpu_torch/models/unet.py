"""ADM-style U-Net score network (port of nshmc_tpu/models/unet.py).

The pixel prior of the flagship run: 256^2, ch 128, mult (1,1,2,2,4,4), one
ResBlock per level, attention at ds16 with 64-channel heads, scale-shift
norm, resblock up/down, learn_sigma (6 output channels).

  - Parameter names are the reference checkpoint's `state_dict` keys
    (input_blocks.{i}.{j}, middle_block.{j}, output_blocks.{i}.{j}, out.{j}:
    the module enumeration of models/port.py::adm_param_mapping), with the
    checkpoint's shapes (attention qkv / proj_out are 1x1 Conv1d), so a
    reference checkpoint loads with `load_state_dict(strict=True)`.
  - Each `TimestepBlock` is one unit of the JAX model (EncoderUnit, the
    downres ResBlock, MiddleUnit, DecoderUnit).
  - Public forward: NHWC in, NHWC float32 out. Inside: NCHW channels_last.
  - bf16 torso with fp32 GroupNorm islands: conv and linear weights are
    stored in the compute dtype, GN parameters in fp32.
  - Remat policy "big" (nshmc_tpu/models/unet.py:394-412): units whose input
    resolution is >= remat_min_res run under torch.utils.checkpoint.
  - The U-Net is a frozen prior: parameters have requires_grad=False, so a
    backward pass computes input gradients only.
  - Class-conditional (`num_classes`): `label_emb`, an fp32 embedding table
    added to the timestep embedding (which it promotes to fp32, as JAX
    does). Conditional (`context_dim`): every attention site is a
    cross-attention SpatialTransformer (models/ldm/transformer.py) of
    `transformer_depth` blocks in place of AttentionBlock, and `context`
    reaches each of them, checkpointed units included.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from .nn import (GroupNorm32, GroupNormSiLU, avg_pool_2x, nchw,
                 nearest_upsample_2x, nhwc, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 256
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 6  # learn_sigma -> [eps | sigma]
    num_res_blocks: int = 1
    attention_ds: Tuple[int, ...] = (16,)
    channel_mult: Tuple[float, ...] = (1, 1, 2, 2, 4, 4)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    # "big": checkpoint units whose input resolution >= remat_min_res (the
    # JAX default); "none": store every activation
    remat: str = "big"
    remat_min_res: int = 128
    # conditional U-Net: SpatialTransformer at the attention sites
    context_dim: Optional[int] = None
    transformer_depth: int = 1
    use_linear_in_transformer: bool = False  # Stable Diffusion 2's linear proj_in/proj_out

    @classmethod
    def from_model_yaml(cls, **kw) -> "UNetConfig":
        """Build from the reference model-config keys
        (nshmc_tpu/models/unet.py:96-132)."""
        image_size = kw.get("image_size", 256)
        channel_mult = kw.get("channel_mult", "") or ""
        if channel_mult == "":
            channel_mult = {
                512: (0.5, 1, 1, 2, 2, 4, 4),
                256: (1, 1, 2, 2, 4, 4),
                128: (1, 1, 2, 3, 4),
                64: (1, 2, 3, 4),
            }[image_size]
        elif isinstance(channel_mult, str):
            channel_mult = tuple(int(m) for m in channel_mult.split(","))
        attn = kw.get("attention_resolutions", "16")
        if isinstance(attn, int):
            attn = [attn]
        elif isinstance(attn, str):
            attn = [int(r) for r in attn.split(",")]
        attention_ds = tuple(image_size // int(r) for r in attn)
        return cls(
            image_size=image_size,
            in_channels=kw.get("in_channels", 3),
            model_channels=kw.get("num_channels", 128),
            out_channels=6 if kw.get("learn_sigma", False) else 3,
            num_res_blocks=kw.get("num_res_blocks", 1),
            attention_ds=attention_ds,
            channel_mult=tuple(channel_mult),
            num_classes=1000 if kw.get("class_cond", False) else None,
            num_heads=kw.get("num_heads", 4),
            num_head_channels=kw.get("num_head_channels", -1),
            num_heads_upsample=kw.get("num_heads_upsample", -1),
            use_scale_shift_norm=kw.get("use_scale_shift_norm", False),
            resblock_updown=kw.get("resblock_updown", False),
        )


def _conv(cin: int, cout: int, kernel: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2)


def _zero(layer: nn.Module) -> nn.Module:
    """Zero-initialised layer (the reference's zero_module; the JAX
    package's zero_init=True)."""
    for p in layer.parameters():
        nn.init.zeros_(p)
    return layer


class ResBlock(nn.Module):
    """Residual block with timestep conditioning
    (nshmc_tpu/models/unet.py:135-186). Keys: in_layers.{0: norm, 2: conv},
    emb_layers.1, out_layers.{0: norm, 3: conv}, skip_connection."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_scale_shift_norm: bool, up: bool = False, down: bool = False):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(GroupNormSiLU(channels), nn.SiLU(),
                                       _conv(channels, out_channels))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(
            emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels))
        self.out_layers = nn.Sequential(GroupNormSiLU(out_channels), nn.SiLU(),
                                        nn.Dropout(0.0),  # keeps the reference's indices
                                        _zero(_conv(out_channels, out_channels)))
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else _conv(channels, out_channels, kernel=1))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x)  # GN -> SiLU
        if self.up:
            h, x = nearest_upsample_2x(h), nearest_upsample_2x(x)
        elif self.down:
            h, x = avg_pool_2x(h), avg_pool_2x(x)
        h = self.in_layers[2](h)
        lin = self.emb_layers[1]
        emb_out = lin(F.silu(emb).to(lin.weight.dtype)).to(h.dtype)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.out_layers[0](h, scale, shift)  # GN -> h*(1+s)+shift -> SiLU
        else:
            h = self.out_layers[0](h + emb_out[:, :, None, None])
        h = self.out_layers[3](h)
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over flattened tokens
    (nshmc_tpu/models/unet.py:189-222): qkv is heads-major with (q|k|v)
    inside each head. Keys: norm, qkv (3C, C, 1), proj_out (C, C, 1)."""

    def __init__(self, channels: int, num_heads: int, num_head_channels: int):
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"{channels} channels, {num_head_channels}-channel heads")
            self.heads = channels // num_head_channels
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = _zero(nn.Conv1d(channels, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t, ch = hh * ww, c // self.heads
        tokens = nhwc(self.norm(x)).reshape(b, t, c)
        qkv = F.linear(tokens, self.qkv.weight[:, :, 0], self.qkv.bias)
        qkv = qkv.view(b, t, self.heads, 3, ch)
        a = attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :])
        a = F.linear(a.reshape(b, t, c), self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + nchw(a.view(b, hh, ww, c))


class Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.op = _conv(channels, channels, stride=2) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool_2x(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool):
        super().__init__()
        self.conv = _conv(channels, channels) if use_conv else None

    def forward(self, x):
        x = nearest_upsample_2x(x)
        return self.conv(x) if self.conv is not None else x


class TimestepBlock(nn.ModuleList):
    """A run of layers where ResBlocks also take the embedding: one unit of
    the JAX model, and the unit of activation checkpointing."""

    def forward(self, h: torch.Tensor, emb: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                h = layer(h, emb)
            elif getattr(layer, "takes_context", False):  # a SpatialTransformer
                h = layer(h, context)
            else:
                h = layer(h)
        return h


class UNetModel(nn.Module):
    """The full ADM U-Net (nshmc_tpu/models/unet.py:363-481).

    forward(x, timesteps, y=None, context=None): x (B, H, W, C) NHWC,
    timesteps (B,) float, class labels y (B,) int where num_classes is set,
    context (B, S, context_dim) where context_dim is set -> (B, H, W,
    out_channels) float32. Callers slice [..., :3] for epsilon.
    """

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.remat not in ("big", "none"):
            raise ValueError(f"remat policy {cfg.remat!r}: 'big' or 'none'")
        self.cfg, self.dtype = cfg, dtype
        mc = cfg.model_channels
        time_dim = mc * 4
        self.time_embed = nn.Sequential(nn.Linear(mc, time_dim), nn.SiLU(),
                                        nn.Linear(time_dim, time_dim))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, time_dim)

        def res(cin, cout, **kw):
            return ResBlock(cin, time_dim, cout, cfg.use_scale_shift_norm, **kw)

        def attn(c, heads):
            """AttentionBlock, or a SpatialTransformer where context_dim is
            set (nshmc_tpu/models/unet.py:256-283)."""
            if cfg.context_dim is None:
                return AttentionBlock(c, heads, cfg.num_head_channels)
            from .ldm.transformer import SpatialTransformer  # ldm imports this module

            n_heads, d_head = ((heads, c // heads) if cfg.num_head_channels == -1
                               else (c // cfg.num_head_channels, cfg.num_head_channels))
            return SpatialTransformer(c, n_heads, d_head, cfg.transformer_depth,
                                      cfg.context_dim, cfg.use_linear_in_transformer)

        ch = int(cfg.channel_mult[0] * mc)
        self.input_blocks = nn.ModuleList([TimestepBlock([_conv(cfg.in_channels, ch)])])
        self._input_res = [None]  # in_conv: never checkpointed
        input_chans = [ch]
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                out_ch = int(mult * mc)
                layers = [res(ch, out_ch)]
                ch = out_ch
                if ds in cfg.attention_ds:
                    layers.append(attn(ch, cfg.num_heads))
                self.input_blocks.append(TimestepBlock(layers))
                self._input_res.append(cfg.image_size // ds)
                input_chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                down = (res(ch, ch, down=True) if cfg.resblock_updown
                        else Downsample(ch, cfg.conv_resample))
                self.input_blocks.append(TimestepBlock([down]))
                self._input_res.append(cfg.image_size // ds)
                input_chans.append(ch)
                ds *= 2

        self.middle_block = TimestepBlock([res(ch, ch), attn(ch, cfg.num_heads), res(ch, ch)])
        self._middle_res = cfg.image_size // ds

        heads_up = cfg.num_heads_upsample if cfg.num_heads_upsample != -1 else cfg.num_heads
        self.output_blocks = nn.ModuleList()
        self._output_res = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                ich = input_chans.pop()
                out_ch = int(mult * mc)
                layers = [res(ch + ich, out_ch)]
                ch = out_ch
                if ds in cfg.attention_ds:
                    layers.append(attn(ch, heads_up))
                self._output_res.append(cfg.image_size // ds)
                if level and i == cfg.num_res_blocks:
                    layers.append(res(ch, ch, up=True) if cfg.resblock_updown
                                  else Upsample(ch, cfg.conv_resample))
                    ds //= 2
                self.output_blocks.append(TimestepBlock(layers))

        self.out = nn.Sequential(GroupNormSiLU(ch), nn.SiLU(),
                                 _zero(_conv(ch, cfg.out_channels)))

        for m in self.modules():  # bf16 torso, fp32 GroupNorm islands
            if isinstance(m, (nn.Conv2d, nn.Conv1d, nn.Linear)):
                m.to(dtype)
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)
        self.requires_grad_(False)

    def _run(self, block: TimestepBlock, res: Optional[int], h, emb, context):
        cfg = self.cfg
        if (cfg.remat == "big" and res is not None and res >= cfg.remat_min_res
                and torch.is_grad_enabled()):
            # the units draw no random numbers: no RNG state to keep, none to
            # read inside a CUDA graph's capture (sampling/graphs.py)
            return checkpoint(block, h, emb, context, use_reentrant=False,
                              preserve_rng_state=False)
        return block(h, emb, context)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if (y is None) != (cfg.num_classes is None):
            raise ValueError("class labels y must be given exactly when num_classes is set")
        emb = timestep_embedding(timesteps, cfg.model_channels).to(self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](emb)))
        if cfg.num_classes is not None:
            emb = emb + self.label_emb(y)  # the fp32 table promotes emb to fp32

        h = nchw(x).to(self.dtype)
        hs = []
        for block, res in zip(self.input_blocks, self._input_res):
            h = self._run(block, res, h, emb, context)
            hs.append(h)
        h = self._run(self.middle_block, self._middle_res, h, emb, context)
        for block, res in zip(self.output_blocks, self._output_res):
            h = torch.cat([h, hs.pop().to(h.dtype)], dim=1)
            h = self._run(block, res, h, emb, context)
        h = self.out[2](self.out[0](h))  # GN -> SiLU -> conv
        return nhwc(h).float()
