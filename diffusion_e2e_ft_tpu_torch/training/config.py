"""Training configuration, port of `diffusion_e2e_ft_tpu/training/config.py`.

The same fields, defaults and JSON form as the JAX package's `TrainConfig`, so
a config written by either package loads in both; `training/trainer.py`
says how the port runs each option.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # task
    modality: str = "depth"  # depth | normals | joint (GeoWizard)
    noise_type: Optional[str] = "zeros"  # zeros | pyramid | gaussian | None (raw SD 4ch)
    prediction_type: str = "v_prediction"
    # optimization (reference defaults: scripts/*.sh)
    learning_rate: float = 3e-5
    lr_final_ratio: float = 0.01
    lr_warmup_steps: int = 100
    lr_total_iter_length: int = 20000
    max_train_steps: int = 20000
    train_batch_size: int = 2
    gradient_accumulation_steps: int = 16
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    # the reference multiplies schedule lengths by the data-parallel degree
    num_data_parallel: int = 1
    # memory: torch.utils.checkpoint of the whole UNet (save nothing)
    gradient_checkpointing: bool = True
    # what the UNet checkpoint saves: None nothing, "dots" the unbatched products, "dots_all" all products
    remat_policy: Optional[str] = None
    # recompute the frozen-VAE decode in the backward pass
    vae_decode_checkpoint: bool = False
    # the fused GN+SiLU->conv kernel in the trainer's frozen VAE
    fused_vae_kernels: bool = True
    # Adam first-moment dtype (None = fp32)
    adam_mu_dtype: Optional[str] = None
    # GeoWizard joint trainer extras
    ssi_weight: float = 0.5
    angular_weight: float = 1.0
    class_embedding_lr_mult: float = 10.0
    use_ema: bool = False
    ema_decay: float = 0.9999
    # standard diffusion-loss mode (vs e2e task loss)
    e2e: bool = True
    # misc
    seed: int = 0
    checkpointing_steps: int = 20000
    checkpoints_total_limit: Optional[int] = None
    output_dir: str = "model-finetuned"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "TrainConfig":
        return TrainConfig(**json.loads(s))
