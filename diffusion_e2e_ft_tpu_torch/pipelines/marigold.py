"""Marigold-style depth / surface-normal inference, port of
`diffusion_e2e_ft_tpu/pipelines/marigold.py` (single member, zeros noise, DDIM).

The device body is VAE encode -> a Python loop over the DDIM plan (UNet, step)
-> VAE decode -> task postprocessing. With one step and zeros noise, the
production configuration, that is one feed-forward pass. PyTorch runs it
eagerly; there is nothing to compile. A DDPM-class checkpoint (what the
trainers export) runs single-step through the same x0 path, as in the JAX
package. Ensembles, gaussian / pyramid noise, multi-step DDPM and the LCM
scheduler are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.ops import image as im
from diffusion_e2e_ft_tpu_torch.ops import noise as noise_ops
from diffusion_e2e_ft_tpu_torch.ops import scheduler as sched_ops


@dataclasses.dataclass
class MarigoldOutput:
    """Depth in [0, 1]; normals in [-1, 1]. The JAX package's fields, in its
    order; `uncertainty` stays None for a single member (the ensembles that
    fill it are slice C)."""

    depth_np: Optional[np.ndarray] = None
    depth_colored: Optional[np.ndarray] = None
    uncertainty: Optional[np.ndarray] = None
    normal_np: Optional[np.ndarray] = None
    normal_colored: Optional[np.ndarray] = None


def init_random_(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in the flax default scheme: lecun-normal kernels,
    zero biases, unit norm scales, N(0, 0.02) embedding tables and CLIP class
    embeddings."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if (p.ndim >= 2 and isinstance(_owner(module, name), torch.nn.Embedding)) or name.endswith(
                ".class_embedding"
            ):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
            elif p.ndim >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) * fan_in**-0.5)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def _owner(module: torch.nn.Module, param_name: str) -> torch.nn.Module:
    return module.get_submodule(param_name.rsplit(".", 1)[0]) if "." in param_name else module


class MarigoldPipeline:
    """Depth/normal prediction from an E2E-FT (or diffusion) SD2-family checkpoint.

    Construct via `from_hf_dir` (published checkpoints) or `from_random`.
    Parameters are cast to `dtype` (bf16 or fp32) and moved to `device`, the
    card unless the caller asks for another."""

    latent_scale_factor = 0.18215

    def __init__(
        self,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        scheduler_config: sched_ops.SchedulerConfig,
        empty_text_embed,  # [1, L, cross_attention_dim]
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        scheduler_type: str = "ddim",
    ):
        if scheduler_type not in ("ddim", "ddpm"):
            raise NotImplementedError(
                f"{scheduler_type} scheduler is not ported yet (slice C: multi-step, noise, ensembles)"
            )
        self.scheduler_type = scheduler_type
        self.device = torch.device(device)
        self.dtype = dtype
        self.unet = unet.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.vae = vae.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.scheduler_config = scheduler_config
        self.schedule = sched_ops.make_schedule(scheduler_config, device=self.device)
        self.empty_text_embed = torch.as_tensor(np.asarray(empty_text_embed)).to(self.device, dtype)

    def with_mesh(self, mesh) -> "MarigoldPipeline":
        raise NotImplementedError("multi-device ensembles (with_mesh) are not ported yet (slice F: multi-GPU)")

    @classmethod
    def from_hf_dir(cls, path: str, device="cuda", dtype=torch.float32, **kw) -> "MarigoldPipeline":
        from diffusion_e2e_ft_tpu_torch.pipelines import loading

        return loading.load_marigold_pipeline(path, device=device, dtype=dtype, **kw)

    @classmethod
    def from_random(
        cls,
        unet_config: Optional[UNetConfig] = None,
        vae_config: Optional[VAEConfig] = None,
        scheduler_config: Optional[sched_ops.SchedulerConfig] = None,
        seed: int = 0,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ) -> "MarigoldPipeline":
        """Random-weight pipeline (tiny by default). Weights are drawn on the CPU
        from `seed`, so the same seed gives the same model on every device."""
        ucfg = unet_config or UNetConfig.tiny()
        vcfg = vae_config or VAEConfig(
            block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4
        )
        gen = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            unet, vae = UNet2DCondition(ucfg), AutoencoderKL(vcfg)
        unet, vae = unet.to_empty(device="cpu"), vae.to_empty(device="cpu")
        init_random_(unet, gen)
        init_random_(vae, gen)
        empty = np.zeros((1, 2, ucfg.cross_attention_dim), np.float32)
        return cls(
            unet, vae, scheduler_config or sched_ops.SchedulerConfig(), empty,
            device=device, dtype=dtype,
        )

    @torch.inference_mode()
    def infer(
        self, rgb: torch.Tensor, num_steps: int = 1, normals: bool = False, noise: str = "zeros"
    ) -> torch.Tensor:
        """rgb [B,H,W,3] in [-1,1] -> depth [B,H,W] in [0,1] or unit normals
        [B,H,W,3] (fp32)."""
        if noise not in (None, "zeros"):  # the seed-driven generator comes with ensembles
            raise NotImplementedError(f"{noise} noise is not ported yet (slice C: multi-step, noise, ensembles)")
        cfg = self.scheduler_config
        if self.scheduler_type == "ddpm" and num_steps > 1:
            raise NotImplementedError("multi-step DDPM is not ported yet (slice C: multi-step, noise, ensembles)")
        plan = sched_ops.make_plan(cfg, num_steps)
        b, h, w, _ = rgb.shape
        latent = noise_ops.make_noise(noise, (b, self.vae.config.latent_channels, h // 8, w // 8), self.dtype, self.device)
        x = rgb.to(self.device, self.dtype).permute(0, 3, 1, 2)
        rgb_latent = self.vae.encode_mean(x) * self.latent_scale_factor
        context = self.empty_text_embed.expand(b, -1, -1)
        x0 = None
        for t, prev_t in zip(plan.timesteps.tolist(), plan.prev_timesteps.tolist()):
            model_out = self.unet(torch.cat([rgb_latent, latent], dim=1), t, context)
            out = sched_ops.ddim_step(cfg, self.schedule, model_out.float(), t, prev_t, latent.float())
            latent, x0 = out.prev_sample.to(self.dtype), out.pred_original_sample
        decoded = self.vae.decode(x0.to(self.dtype) / self.latent_scale_factor).float()
        decoded = decoded.permute(0, 2, 3, 1)  # [B, H, W, 3]
        if normals:
            return decoded / (decoded.norm(dim=-1, keepdim=True) + 1e-5)
        depth = decoded.mean(dim=-1).clamp(-1.0, 1.0)
        return (depth + 1.0) / 2.0

    @torch.inference_mode()
    def __call__(
        self,
        image: np.ndarray,  # [H, W, 3] uint8/float RGB
        denoising_steps: int = 1,
        ensemble_size: int = 1,
        processing_res: int = 768,
        match_input_res: bool = True,
        resample_method: str = "bilinear",
        batch_size: int = 0,
        noise: str = "zeros",
        normals: bool = False,
        seed: Optional[int] = None,
        color_map: Optional[str] = "Spectral",
        ensemble_kwargs: Optional[dict] = None,
    ) -> MarigoldOutput:
        """The JAX package's arguments, in its order. With one member and zeros
        noise `batch_size` (members per device call), `seed` (it keys only the
        noise) and `ensemble_kwargs` (they tune only the ensembling) leave the
        output as it is; an ensemble or random noise, where they would change
        it, raises."""
        if denoising_steps < 1:
            raise ValueError("denoising_steps must be >= 1")
        if ensemble_size < 1:
            raise ValueError("ensemble_size must be >= 1")
        if ensemble_size != 1:
            raise NotImplementedError("ensembles are not ported yet (slice C: multi-step, noise, ensembles)")
        img = np.asarray(image)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"Expected [H, W, 3] RGB image, got {img.shape}")
        orig_hw = tuple(img.shape[:2])

        rgb = torch.from_numpy(img.astype(np.float32)).to(self.device)
        if processing_res > 0:
            rgb = im.resize_max_res(rgb, processing_res, method=resample_method)
        pred = self.infer(im.normalize_rgb(rgb)[None], denoising_steps, normals, noise)[0]

        if normals:
            normal = pred / (pred.norm(dim=-1, keepdim=True) + 1e-5)
            if match_input_res and tuple(normal.shape[:2]) != orig_hw:
                normal = im.resize(normal, orig_hw, method=resample_method)
                normal = normal / (normal.norm(dim=-1, keepdim=True) + 1e-5)
            normal = normal.clamp(-1.0, 1.0).cpu().numpy()
            colored = im.colorize_normals(normal) if color_map is not None else None
            return MarigoldOutput(normal_np=normal, normal_colored=colored)

        depth = (pred - pred.min()) / (pred.max() - pred.min()).clamp_min(1e-8)  # min-max to [0, 1]
        if match_input_res and tuple(depth.shape) != orig_hw:
            depth = im.resize(depth[..., None], orig_hw, method=resample_method)[..., 0]
        depth = depth.clamp(0.0, 1.0).cpu().numpy()
        colored = None
        if color_map is not None:
            colored = (im.colorize_depth(depth, 0.0, 1.0, cmap=color_map) * 255).astype(np.uint8)
        return MarigoldOutput(depth_np=depth, depth_colored=colored)
