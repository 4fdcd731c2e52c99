"""nshmc_tpu_torch.models: the ADM U-Net and the CelebA-HQ DDPM prior."""
from .unet import UNetConfig, UNetModel
from .ddpm_simple import DDPMConfig, DDPMModel, ddpm_state_dict_from_jax, load_ddpm_checkpoint
