from .autoencoder import (AutoencoderConfig, AutoencoderKL, Decoder, Encoder, VectorQuantizer,
                          VQModel)
from .distributions import DiagonalGaussian, ema_update
from .ldm import LatentDiffusion, latent_unet_config

__all__ = [
    "AutoencoderConfig", "VQModel", "AutoencoderKL", "Encoder", "Decoder",
    "VectorQuantizer", "DiagonalGaussian", "ema_update",
    "LatentDiffusion", "latent_unet_config",
]
