"""The DDPM "simple" U-Net, the CelebA-HQ prior (port of
nshmc_tpu/models/ddpm_simple.py).

The pesser/pytorch_diffusion network: the VQ autoencoder's blocks
(models/ldm/autoencoder.py: GroupNorm eps 1e-6, SiLU, the asymmetric-pad
stride-2 downsample, single-head AttnBlock) with timestep conditioning:

    temb = dense.1(silu(dense.0(emb(t))));  h = conv1(silu(norm1(x))) + temb_proj(silu(temb))

  - The embedding is not ADM's: [sin | cos] order with a 1/(half - 1)
    frequency spacing (`ddpm_timestep_embedding`).
  - Parameter names are the reference's `state_dict` keys (temb.dense.{0,1},
    conv_in, down.{i}.block.{j}.{norm1,conv1,temb_proj,norm2,conv2,
    nin_shortcut}, down.{i}.attn.{j}, down.{i}.downsample.conv, mid.block_1,
    mid.attn_1, mid.block_2, up.{i}..., norm_out, conv_out), so a reference
    checkpoint loads with `load_state_dict(strict=True)` once its `logvar`
    entry is set aside (`load_ddpm_checkpoint`); `ddpm_state_dict_from_jax`
    is the inverse of nshmc_tpu/models/ddpm_simple.py::port_ddpm_state_dict.
  - Every norm -> SiLU pair goes through the GroupNorm+SiLU kernels (K2a,
    K2b, and K2c in a backward) at eps 1e-6; the AttnBlocks' norm runs K2a.
  - Public tensors are NHWC and the output is float32; inside, activations
    are NCHW channels_last. Convolutions and linears are stored in the
    compute dtype, norms in fp32. No activation checkpointing, as in JAX.
  - A frozen prior: parameters have requires_grad=False.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .ldm.autoencoder import AE_EPS, AEAttnBlock, AEDownsample, AEUpsample, _conv
from .ldm.port import _ae_attn_entries, _ae_block_entries
from .nn import GroupNormSiLU, nchw, nhwc
from .port import _from_jax


def ddpm_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin | cos] embedding with 1/(half - 1) spacing, zero-padded to an odd
    dim: (B,) -> (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      * -(math.log(10000) / (half - 1)))
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    """CelebA-HQ defaults (nshmc_tpu/models/ddpm_simple.py:47-59). The JAX
    config's `dropout` and `resamp_with_conv` are left out: its network
    reads neither (no dropout at inference, conv resampling always)."""

    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    resolution: int = 256


class TembResBlock(nn.Module):
    """The autoencoder's ResnetBlock plus temb_proj(silu(temb)), broadcast
    over H and W between conv1 and norm2."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_channels, eps=AE_EPS)
        self.conv1 = _conv(in_channels, out_channels)
        self.temb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNormSiLU(out_channels, eps=AE_EPS)
        self.conv2 = _conv(out_channels, out_channels)
        self.nin_shortcut = (_conv(in_channels, out_channels, kernel=1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


def _level() -> nn.Module:
    level = nn.Module()
    level.block, level.attn = nn.ModuleList(), nn.ModuleList()
    return level


class DDPMModel(nn.Module):
    """forward(x, t): x (B, H, W, in_channels) NHWC, t (B,) float ->
    (B, H, W, out_ch) float32, the eps prediction."""

    def __init__(self, cfg: DDPMConfig = DDPMConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        ch, temb_ch = cfg.ch, cfg.ch * 4
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])
        self.conv_in = _conv(cfg.in_channels, ch)

        curr_res, block_in = cfg.resolution, ch
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(cfg.ch_mult):
            level = _level()
            for _ in range(cfg.num_res_blocks):
                level.block.append(TembResBlock(block_in, ch * mult, temb_ch))
                block_in = ch * mult
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AEAttnBlock(block_in))
            if i != len(cfg.ch_mult) - 1:
                level.downsample = AEDownsample(block_in)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = TembResBlock(block_in, block_in, temb_ch)
        self.mid.attn_1 = AEAttnBlock(block_in)
        self.mid.block_2 = TembResBlock(block_in, block_in, temb_ch)

        levels = []  # built from the deepest level up, indexed by level
        for i in reversed(range(len(cfg.ch_mult))):
            level = _level()
            block_out, skip_in = ch * cfg.ch_mult[i], ch * cfg.ch_mult[i]
            for j in range(cfg.num_res_blocks + 1):
                if j == cfg.num_res_blocks:
                    skip_in = ch * in_ch_mult[i]
                level.block.append(TembResBlock(block_in + skip_in, block_out, temb_ch))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AEAttnBlock(block_in))
            if i != 0:
                level.upsample = AEUpsample(block_in)
                curr_res *= 2
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNormSiLU(block_in, eps=AE_EPS)
        self.conv_out = _conv(block_in, cfg.out_ch)

        for m in self.modules():  # convs and linears in the compute dtype, norms fp32
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype)
            if isinstance(m, nn.Conv2d):
                m.to(memory_format=torch.channels_last)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = ddpm_timestep_embedding(t, self.cfg.ch).to(self.dtype)
        temb = self.temb.dense[1](F.silu(self.temb.dense[0](temb)))

        hs = [self.conv_in(nchw(x).to(self.dtype))]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[j](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)), temb)
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop().to(h.dtype)], dim=1), temb)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        assert not hs
        return nhwc(self.conv_out(self.norm_out(h))).float()


def ddpm_param_mapping(cfg: DDPMConfig) -> Dict[str, Tuple[str, str]]:
    """JAX layer path -> (reference key prefix, kind)
    (nshmc_tpu/models/ddpm_simple.py:138-187)."""

    def temb_block(jax_prefix, torch_prefix, has_shortcut):
        out = _ae_block_entries(jax_prefix, torch_prefix, has_shortcut)
        out[f"{jax_prefix}/temb_proj"] = (f"{torch_prefix}.temb_proj", "dense")
        return out

    m = {"temb_dense_0": ("temb.dense.0", "dense"), "temb_dense_1": ("temb.dense.1", "dense"),
         "conv_in": ("conv_in", "conv"), "norm_out": ("norm_out", "groupnorm"),
         "conv_out": ("conv_out", "conv")}
    curr_res, block_in = cfg.resolution, cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        block_out = cfg.ch * mult
        for j in range(cfg.num_res_blocks):
            m.update(temb_block(f"down_{i}_block_{j}", f"down.{i}.block.{j}",
                                block_in != block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                m.update(_ae_attn_entries(f"down_{i}_attn_{j}", f"down.{i}.attn.{j}"))
        if i != len(cfg.ch_mult) - 1:
            m[f"down_{i}_downsample/conv"] = (f"down.{i}.downsample.conv", "conv")
            curr_res //= 2
    m.update(temb_block("mid_block_1", "mid.block_1", False))
    m.update(_ae_attn_entries("mid_attn_1", "mid.attn_1"))
    m.update(temb_block("mid_block_2", "mid.block_2", False))
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    for i in reversed(range(len(cfg.ch_mult))):
        block_out = skip_in = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            if j == cfg.num_res_blocks:
                skip_in = cfg.ch * in_ch_mult[i]
            m.update(temb_block(f"up_{i}_block_{j}", f"up.{i}.block.{j}",
                                block_in + skip_in != block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                m.update(_ae_attn_entries(f"up_{i}_attn_{j}", f"up.{i}.attn.{j}"))
        if i != 0:
            m[f"up_{i}_upsample/conv"] = (f"up.{i}.upsample.conv", "conv")
            curr_res *= 2
    return m


def ddpm_state_dict_from_jax(params, cfg: DDPMConfig) -> Dict[str, torch.Tensor]:
    """JAX DDPMModel params ({"params": {...}} or the inner tree, leaves as
    numpy arrays) -> float32 port state_dict with the reference keys."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for path, (prefix, kind) in ddpm_param_mapping(cfg).items():
        node = tree
        for part in path.split("/"):
            node = node[part]
        for name, arr in _from_jax(kind, node).items():
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def load_ddpm_checkpoint(path: str, cfg: DDPMConfig = DDPMConfig(), dtype=torch.float32,
                         device="cuda") -> DDPMModel:
    """A reference checkpoint (celeba_hq.ckpt) -> a frozen DDPMModel on
    `device`; its `logvar` entry, which the network does not use, is set
    aside and every other key must load (strict)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if k != "logvar"}
    model = DDPMModel(cfg, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
