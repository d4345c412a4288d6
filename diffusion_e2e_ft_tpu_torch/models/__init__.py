"""SD2 models in torch.nn: VAE, conditional UNet, CLIP text tower, weight conversion."""

from diffusion_e2e_ft_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from diffusion_e2e_ft_tpu_torch.models.vae import AutoencoderKL, VAEConfig

__all__ = ["AutoencoderKL", "UNet2DCondition", "UNetConfig", "VAEConfig"]
