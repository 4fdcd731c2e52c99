"""The KL-f8 first stage's decode path as plain PyTorch (the CompVis LDM's
AutoencoderKL.decode: post_quant_conv, then reference/vq.py's Decoder, with
no quantizer), float32 by default. The latent is divided by the
configuration's scale_factor first (LatentDiffusion.decode_first_stage).
Parameter names are the checkpoint's first_stage_model keys (decoder.*,
post_quant_conv)."""
from __future__ import annotations

import torch
import torch.nn as nn

from .unet import Numerics
from .vq import Decoder, VQSpec, conv


class KLDecode(nn.Module):
    """decode(z (B, h, w, embed_dim) NHWC) -> image (B, 8h, 8w, 3) NHWC
    float32 for ch_mult of four levels."""

    def __init__(self, spec: VQSpec, scale_factor: float):
        super().__init__()
        self.numerics = Numerics()
        self.scale_factor = scale_factor
        self.post_quant_conv = conv(spec.embed_dim, spec.z_channels, 1)
        self.decoder = Decoder(spec)
        self.requires_grad_(False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        nm = self.numerics
        h = nm.act(nm.conv(self.post_quant_conv, (z / self.scale_factor).permute(0, 3, 1, 2)))
        return self.decoder(h, nm).permute(0, 2, 3, 1)
