"""Inference pipelines."""

from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import GeoWizardOutput, GeoWizardPipeline
from diffusion_e2e_ft_tpu_torch.pipelines.marigold import MarigoldOutput, MarigoldPipeline

__all__ = ["GeoWizardOutput", "GeoWizardPipeline", "MarigoldOutput", "MarigoldPipeline"]
