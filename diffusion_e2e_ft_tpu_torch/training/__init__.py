"""End-to-end fine-tuning: the train step (UNet -> x0 -> frozen VAE decode ->
task loss) for depth or normals and GeoWizard's joint one, the optimizer with optax's semantics, the LR schedule, gradient
accumulation and EMA, checkpoints and the loop."""

from diffusion_e2e_ft_tpu_torch.training.config import TrainConfig
from diffusion_e2e_ft_tpu_torch.training.geowizard import GeoWizardTrainer
from diffusion_e2e_ft_tpu_torch.training.lr import iter_exponential_schedule
from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer, TrainState, gather_state, gather_tensors

__all__ = ["E2ETrainer", "GeoWizardTrainer", "TrainConfig", "TrainState", "gather_state", "gather_tensors",
           "iter_exponential_schedule"]
