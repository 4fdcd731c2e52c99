"""LatentDiffusion: latent U-Net + VQ first stage + registered schedule
(port of nshmc_tpu/models/ldm/ldm.py).

The latent U-Net is the ADM UNetModel (models/unet.py) at openaimodel's
settings (`latent_unet_config`: no scale-shift norm, conv up/downsampling,
one head per block with `num_head_channels`-channel heads, 3 output
channels). At configs/ffhq_latent.yaml's widths (ch 224, mult 1,2,3,4,
attention at ds 2/4/8, 32-channel heads) its attention blocks run at 1024,
256 and 64 tokens with 14, 21 and 28 heads.

`LatentDiffusion` is an nn.Module whose state_dict has a Lightning LDM
checkpoint's prefixes (`model.diffusion_model.*`, `first_stage_model.*`).
Its `apply_model` runs the eps-net under `torch.no_grad()` by default, the
reference's `@torch.no_grad apply_model`: the eps prediction is a constant
of the graph, so a gradient through the DDIM ladder flows only through the
ladder's linear recombination and the VQ decoder.

LDM's 'linear' beta schedule is a linspace in sqrt space, which is this
package's 'quad' schedule with linear_start 0.0015, linear_end 0.0195.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ...schedules import DiffusionSchedule
from ..unet import UNetConfig, UNetModel
from .autoencoder import AutoencoderConfig, VQModel
from .port import split_ldm_checkpoint


def latent_unet_config(image_size: int = 64, model_channels: int = 224,
                       num_res_blocks: int = 2, channel_mult=(1, 2, 3, 4),
                       attention_ds=(8, 4, 2), num_head_channels: int = 32,
                       in_channels: int = 3, out_channels: int = 3) -> UNetConfig:
    """openaimodel.UNetModel parameters; `attention_ds` are downsampling
    factors already (nshmc_tpu/models/ldm/ldm.py:31-56)."""
    return UNetConfig(image_size=image_size, in_channels=in_channels,
                      model_channels=model_channels, out_channels=out_channels,
                      num_res_blocks=num_res_blocks, attention_ds=tuple(attention_ds),
                      channel_mult=tuple(channel_mult), num_heads=1,
                      num_head_channels=num_head_channels, use_scale_shift_norm=False,
                      resblock_updown=False, conv_resample=True)


class LatentDiffusion(nn.Module):
    """The latent eps-net, the VQ first stage and the schedule; frozen."""

    def __init__(self, unet_cfg: Optional[UNetConfig] = None,
                 ae_cfg: Optional[AutoencoderConfig] = None,
                 schedule: Optional[DiffusionSchedule] = None, scale_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(unet_cfg or latent_unet_config(), dtype)
        self.first_stage_model = VQModel(ae_cfg or AutoencoderConfig(), dtype)
        self.schedule = schedule
        self.scale_factor = scale_factor
        self.requires_grad_(False)

    @classmethod
    def create(cls, unet_cfg: Optional[UNetConfig] = None,
               ae_cfg: Optional[AutoencoderConfig] = None, linear_start: float = 0.0015,
               linear_end: float = 0.0195, num_timesteps: int = 1000,
               dtype: torch.dtype = torch.float32, device="cuda",
               seed: int = 0) -> "LatentDiffusion":
        """Randomly initialised (torch's layer init under `seed`, the
        reference's zero-initialised output layers included) on `device`."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            ldm = cls(unet_cfg, ae_cfg, dtype=dtype)
        ldm.schedule = DiffusionSchedule.create("quad", linear_start, linear_end, num_timesteps,
                                                device=device)
        return ldm.to(device).eval()

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def first_stage(self) -> VQModel:
        return self.first_stage_model

    def load_checkpoint(self, sd) -> None:
        """Load a Lightning LatentDiffusion state_dict (strict for both
        models); a registered alphas_cumprod replaces the schedule."""
        unet_sd, ae_sd, alphas_cumprod = split_ldm_checkpoint(sd)
        self.unet.load_state_dict(unet_sd, strict=True)
        self.first_stage.load_state_dict(ae_sd, strict=True)
        if alphas_cumprod is not None:
            self.schedule = DiffusionSchedule.from_alphas_cumprod(
                alphas_cumprod, device=self.schedule.betas.device)

    # -- eps model ----------------------------------------------------------
    def apply_model(self, z: torch.Tensor, t: torch.Tensor,
                    stop_gradient: bool = True) -> torch.Tensor:
        """eps prediction, NHWC float32; under `stop_gradient` (the default)
        computed without autograd, a constant to any backward pass."""
        if stop_gradient:
            with torch.no_grad():
                return self.unet(z, t)
        return self.unet(z, t)

    def model_fn(self, stop_gradient: bool = True):
        return lambda z, t: self.apply_model(z, t, stop_gradient)

    # -- first stage --------------------------------------------------------
    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """The VQ decode, differentiable in z through the straight-through
        quantizer (the reference's differentiable_decode_first_stage)."""
        return self.first_stage.decode(z / self.scale_factor, force_not_quantize)

    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        return self.first_stage.encode(x) * self.scale_factor
