"""Inference pipelines."""

from diffusion_e2e_ft_tpu_torch.pipelines.marigold import MarigoldOutput, MarigoldPipeline

__all__ = ["MarigoldOutput", "MarigoldPipeline"]
