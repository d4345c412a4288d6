"""GeoWizard joint depth + normal fine-tuning, port of
`diffusion_e2e_ft_tpu/training/geowizard.py`.

The same optimizer and step machinery as `E2ETrainer`, with the joint loss:
the frozen VAE encodes the image and the latent is doubled into a task pair
([depth half; normal half], 2B); the frozen CLIP vision tower embeds the
[0, 1] image (one token, doubled); the 10-dim sin/cos switcher of the task
and the batch's domain feeds the UNet's class embedding (its 10x LR group is
the optimizer's, `class_embedding_lr_mult`); the UNet runs joint cross-task
attention.

- E2E mode (`e2e=True`, the default): t = 999 for the whole pair, the noise
  latent of `noise_type` (GeoWizard's pyramid: r ~ U[1.5, 3], octaves scaled
  by t/1000), x0 from the prediction, the frozen-VAE decode inside the graph;
  depth = the channel mean clipped to [-1, 1], normals unit-normalized
  (+1e-5) and clipped, the GT normals flipped (x -1) to GeoWizard's
  convention; loss = `ssi_weight` SSI + `angular_weight` angular, each
  NaN-guarded, with both as metrics.
- Diffusion-loss mode (`e2e=False`): t ~ U{0..999} per sample, repeated for
  both halves; the GT geometry latents (depth repeated to 3 channels; -normals)
  encoded without grad; noisy = `add_noise`; the target is the velocity
  (v_prediction) or the noise; the squared error masked by the 8x max-pooled
  latent validity (doubled), over max(sum(mask) C, 1).

A batch with no valid pixel has loss 0. In a data-parallel group (see
`trainer.py`; over its data axis, the frozen image tower replicated on every
rank) both terms of the E2E loss, and the diffusion loss, divide by
the global batch's counts, each term is NaN-guarded on its global value, and
t and the noise are drawn for the global batch, the pair's rows taken from
both halves. Batch leaves (numpy or torch): rgb
[B,H,W,3] in [-1,1]; depth_target [B,H,W]; normal_target [B,H,W,3] (the
standard convention, flipped here); val_mask [B,H,W] bool; domain [3] one-hot
(per batch; indoor when absent).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition
from diffusion_e2e_ft_tpu_torch.models import clip as clip_models
from diffusion_e2e_ft_tpu_torch.ops import losses as L
from diffusion_e2e_ft_tpu_torch.ops import scheduler as sched_ops
from diffusion_e2e_ft_tpu_torch.parallel.mesh import frozen_copy
from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import switcher_embedding
from diffusion_e2e_ft_tpu_torch.training.config import TrainConfig
from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer


def latent_valid_mask(val_mask: torch.Tensor) -> torch.Tensor:
    """8x max-pool of the INVALID mask -> latent-resolution validity [B, H/8, W/8]:
    a latent cell is invalid if any of its 8x8 pixels is."""
    invalid = (~val_mask.bool()).float()[:, None]
    return F.max_pool2d(invalid, kernel_size=8, stride=8)[:, 0] < 0.5


class GeoWizardTrainer(E2ETrainer):
    """Joint trainer: `E2ETrainer`'s optimizer and step, the joint-task loss."""

    MODALITIES = ("joint",)
    PYRAMID_BANK = (1.5, 1.5)  # GeoWizard's octave scales r ~ U[1.5, 3]

    def __init__(
        self,
        config: TrainConfig,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        image_encoder: clip_models.CLIPVisionModelWithProjection,
        scheduler_config: Optional[sched_ops.SchedulerConfig] = None,
        latent_scale: float = 0.18215,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__(
            config.replace(modality="joint"), unet, vae,
            np.zeros((1, 1, unet.config.cross_attention_dim), np.float32),
            scheduler_config, latent_scale, compute_dtype,
        )
        self.image_encoder = frozen_copy(image_encoder, self.device)

    def _global_t(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's timesteps from this rank's (explicit ones; drawn
        ones are drawn for the global batch)."""
        if self.dp is None or self.dp.data_size == 1:
            return t
        parts = [torch.zeros_like(t) for _ in range(self.dp.data_size)]
        parts[self.dp.data_index] = t
        return self.dp.all_sum(torch.cat(parts))

    def loss(
        self, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None, *,
        timesteps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The joint loss of one batch. t (diffusion mode) and the noise latent
        ([2B, 4, h, w]) are drawn from `generator` unless given."""
        c = self.config
        rgb_nhwc = self._tensor(batch["rgb"], torch.float32)
        rgb = rgb_nhwc.permute(0, 3, 1, 2)
        mask = self._tensor(batch["val_mask"], torch.bool)
        depth_gt = self._tensor(batch["depth_target"], torch.float32)
        normal_gt = self._tensor(batch["normal_target"], torch.float32)
        b = rgb.shape[0]
        with self._autocast():
            rgb_latents = self._encode(rgb)
            rgb_latents2 = torch.cat([rgb_latents, rgb_latents])
            with torch.no_grad():  # the frozen CLIP vision tower
                embed = self.image_encoder(clip_models.clip_preprocess((rgb_nhwc + 1.0) / 2.0))[:, None, :]
            context = torch.cat([embed, embed])
            class_vec = switcher_embedding(batch.get("domain", [1.0, 0.0, 0.0]), batch=b).to(self.device)

            world = 1 if self.dp is None else self.dp.data_size
            if c.e2e:  # the single step: noise is the input at t = 999
                t_all = torch.full((b * world,), self.scheduler_config.num_train_timesteps - 1, dtype=torch.long,
                                   device=self.device)
                t2 = torch.cat([self._rows(t_all)] * 2)
                noisy = self._noise(rgb_latents2.shape, generator, torch.cat([t_all, t_all]), pair=True) \
                    if noise is None else noise.to(rgb_latents)
            else:  # standard diffusion training: GT geometry latents plus noise at a random t
                if timesteps is not None:
                    t_all = self._global_t(torch.as_tensor(timesteps, device=self.device).long())
                elif generator is None:
                    raise ValueError("the diffusion-loss mode draws t from a torch.Generator: pass one to the step")
                else:  # drawn for the global batch
                    t_all = torch.randint(0, self.scheduler_config.num_train_timesteps, (b * world,),
                                          generator=generator, device=self.device)
                t2 = torch.cat([self._rows(t_all)] * 2).long()
                geo = torch.cat([depth_gt[..., None].expand(-1, -1, -1, 3), -normal_gt]).permute(0, 3, 1, 2)
                geo_latents = self._encode(geo)
                eps = self._noise(geo_latents.shape, generator, torch.cat([t_all, t_all]), pair=True) \
                    if noise is None else noise.to(geo_latents)
                noisy = sched_ops.add_noise(self.schedule, geo_latents, eps, t2)

            model_pred = self._unet(torch.cat([rgb_latents2, noisy], dim=1), t2, context, class_vec).float()
            if c.e2e:
                x0 = sched_ops.pred_original_sample(self.scheduler_config, self.schedule, model_pred, t2, noisy)
                decoded = self._decode(x0)  # [2B, H, W, 3]

        metrics: Dict[str, torch.Tensor] = {}
        count = self._valid_count(mask)
        if c.e2e:
            depth_dec, normal_dec = decoded[:b], decoded[b:]
            depth_est = depth_dec.mean(dim=-1).clamp(-1.0, 1.0)
            normal_est = (normal_dec / (torch.linalg.vector_norm(normal_dec, dim=-1, keepdim=True) + 1e-5)).clamp(
                -1.0, 1.0)
            # the reference flips the GT normals into GeoWizard's convention
            ssi = self._nan_guarded(L.ssi_loss(depth_est, depth_gt, mask, count))
            ang = self._nan_guarded(L.angular_loss(normal_est, -normal_gt, mask, count))
            loss = c.ssi_weight * ssi + c.angular_weight * ang
            metrics.update({"loss_ssi": ssi.detach(), "loss_angular": ang.detach()})
        else:
            if self.scheduler_config.prediction_type == "v_prediction":
                target = sched_ops.velocity(self.schedule, geo_latents, eps, t2)
            else:
                target = eps
            lmask = latent_valid_mask(mask)
            lmask2 = torch.cat([lmask, lmask])[:, None].float()  # [2B, 1, h, w]
            se = (model_pred - target) ** 2 * lmask2
            cells = lmask2.sum() if self.dp is None else self.dp.all_sum(lmask2.sum())
            loss = se.sum() / (cells * target.shape[1]).clamp_min(1.0)
        # an all-invalid batch contributes zero loss (the reference skips it)
        loss = torch.where(self._any_valid(mask, count), loss, torch.zeros_like(loss))
        metrics["loss"] = loss.detach()
        return loss, metrics
