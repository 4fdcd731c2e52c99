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

The first stage is a `VQModel`, or an `AutoencoderKL` where the
AutoencoderConfig has `double_z` (Stable Diffusion's KL-f8: its decode is
post_quant_conv and the decoder, with no quantizer). `decode_first_stage`
divides by `scale_factor` first (0.18215 for SD). A conditional U-Net
(`context_dim` set) reads the context that `set_context` copied into one
fixed buffer, shared by every chain of the batch; the buffer is a
(non-persistent) buffer of `self.model`, the module `model_fn` hands a DDIM
decoder, so a CUDA graph's replay reads the context in hand, and a context
of another shape (a new buffer) makes the decoder capture again.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn as nn

from ...schedules import DiffusionSchedule
from ...utils import profiling
from ..unet import UNetConfig, UNetModel
from .autoencoder import AutoencoderConfig, AutoencoderKL, VQModel
from .port import split_ldm_checkpoint


def latent_unet_config(image_size: int = 64, model_channels: int = 224,
                       num_res_blocks: int = 2, channel_mult=(1, 2, 3, 4),
                       attention_ds=(8, 4, 2), num_head_channels: int = 32,
                       in_channels: int = 3, out_channels: int = 3,
                       context_dim: Optional[int] = None, transformer_depth: int = 1,
                       use_linear_in_transformer: bool = False) -> UNetConfig:
    """openaimodel.UNetModel parameters; `attention_ds` are downsampling
    factors already (nshmc_tpu/models/ldm/ldm.py:31-56). `context_dim` makes
    it conditional (Stable Diffusion's)."""
    return UNetConfig(image_size=image_size, in_channels=in_channels,
                      model_channels=model_channels, out_channels=out_channels,
                      num_res_blocks=num_res_blocks, attention_ds=tuple(attention_ds),
                      channel_mult=tuple(channel_mult), num_heads=1,
                      num_head_channels=num_head_channels, use_scale_shift_norm=False,
                      resblock_updown=False, conv_resample=True, context_dim=context_dim,
                      transformer_depth=transformer_depth,
                      use_linear_in_transformer=use_linear_in_transformer)


class LatentDiffusion(nn.Module):
    """The latent eps-net, the VQ or KL first stage and the schedule; frozen."""

    def __init__(self, unet_cfg: Optional[UNetConfig] = None,
                 ae_cfg: Optional[AutoencoderConfig] = None,
                 schedule: Optional[DiffusionSchedule] = None, scale_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ae_cfg = ae_cfg or AutoencoderConfig()
        self.model = nn.Module()
        self.model.diffusion_model = UNetModel(unet_cfg or latent_unet_config(), dtype)
        self.model.register_buffer("context", None, persistent=False)
        self.first_stage_model = (AutoencoderKL if ae_cfg.double_z else VQModel)(ae_cfg, dtype)
        self.schedule = schedule
        self.scale_factor = scale_factor
        self.requires_grad_(False)

    @classmethod
    def create(cls, unet_cfg: Optional[UNetConfig] = None,
               ae_cfg: Optional[AutoencoderConfig] = None, linear_start: float = 0.0015,
               linear_end: float = 0.0195, num_timesteps: int = 1000,
               dtype: torch.dtype = torch.float32, device="cuda",
               seed: int = 0, scale_factor: float = 1.0) -> "LatentDiffusion":
        """Randomly initialised (torch's layer init under `seed`, the
        reference's zero-initialised output layers included) on `device`."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            ldm = cls(unet_cfg, ae_cfg, scale_factor=scale_factor, dtype=dtype)
        ldm.schedule = DiffusionSchedule.create("quad", linear_start, linear_end, num_timesteps,
                                                device=device)
        return ldm.to(device).eval()

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    @property
    def first_stage(self) -> "VQModel | AutoencoderKL":
        return self.first_stage_model

    @property
    def conditional(self) -> bool:
        return self.unet.cfg.context_dim is not None

    def set_context(self, context: torch.Tensor) -> None:
        """The conditional U-Net's context, (S, context_dim) or (1, S,
        context_dim), shared by every chain: copied into the buffer a
        captured graph reads where it has this shape, a new buffer where not."""
        ctx = context.reshape((1,) + tuple(context.shape[-2:]))
        if ctx.shape[-1] != self.unet.cfg.context_dim:
            raise ValueError(f"context of width {ctx.shape[-1]}, the U-Net takes "
                             f"{self.unet.cfg.context_dim}")
        held = self.model.context
        if held is not None and held.shape == ctx.shape:
            held.copy_(ctx)
        else:
            device = self.unet.time_embed[0].weight.device
            self.model.context = ctx.to(device=device, dtype=torch.float32).clone()

    def load_checkpoint(self, sd) -> None:
        """Load a Lightning LatentDiffusion state_dict (strict for both
        models; the text encoder's `cond_stage_model.*` keys are not read);
        a registered alphas_cumprod replaces the schedule."""
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
        computed without autograd, a constant to any backward pass. A
        conditional U-Net gets the held context, one for every chain."""
        context = None
        if self.conditional:
            if self.model.context is None:
                raise ValueError("a conditional U-Net needs a context: call set_context")
            context = self.model.context.expand(z.shape[0], -1, -1)
        if stop_gradient:
            with torch.no_grad():
                return self.unet(z, t, context=context)
        return self.unet(z, t, context=context)

    def model_fn(self, stop_gradient: bool = True):
        """`apply_model` as a ModelFn; `.module` is the eps-net it calls (a
        DDIM decoder observes its hooks and weights, sampling/graphs.py),
        with the context's buffer where the U-Net is conditional."""
        fn = functools.partial(self.apply_model, stop_gradient=stop_gradient)
        fn.module = self.model if self.conditional else self.unet
        return fn

    # -- first stage --------------------------------------------------------
    def decode_first_stage(self, z: torch.Tensor,
                           force_not_quantize: bool = False) -> torch.Tensor:
        """The first stage's decode, differentiable in z (the VQ's through
        the straight-through quantizer; the reference's
        differentiable_decode_first_stage): the span `kl.decode` or
        `vq.decode`, timed on the device (utils/profiling.py::device_ms)."""
        if isinstance(self.first_stage, AutoencoderKL):
            with profiling.span("kl.decode", timed=True):
                return self.first_stage.decode(z / self.scale_factor)
        with profiling.span("vq.decode", timed=True):
            return self.first_stage.decode(z / self.scale_factor, force_not_quantize)

    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.first_stage, AutoencoderKL):
            return self.first_stage.encode(x).mode() * self.scale_factor
        return self.first_stage.encode(x) * self.scale_factor
