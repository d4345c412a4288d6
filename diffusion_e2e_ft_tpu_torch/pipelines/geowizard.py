"""GeoWizard joint depth + surface-normal inference, port of
`diffusion_e2e_ft_tpu/pipelines/geowizard.py` (single member, zeros noise, DDIM).

The device body: VAE encode of the image, duplicated into a task pair
([depth half; normal half]); CLIP-vision conditioning on the [0, 1] image; the
10-dim task / domain switcher fed to the UNet's class embedding; a Python loop
over the DDIM plan whose UNet runs joint cross-task self-attention; one
batched decode of both halves; depth = channel mean mapped to [0, 1], normal =
the unit vector flipped to GeoWizard's convention. The JAX package decodes the
two halves as batch-1 calls under `lax.map` for a TPU layout problem; here they
are one batch of 2. DDIM only, as the JAX pipeline.

`__call__` draws each member's initial latent (zeros, gaussian or pyramid)
from a `torch.Generator` seeded with `seed`, shared by the member's depth and
normal halves; it runs the members in chunks of `batch_size`, each chunk one
2N batch through the UNet (joint attention over each member's pair) and the
decode, and ensembles them: `ensemble_depths` for depth with its
uncertainty, `ensemble_normals` for normals. `with_mesh` splits each chunk's
members over several devices. Under a profiler session `__call__` records
the spans of `utils/trace.py`, as `MarigoldPipeline.__call__` does.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as clip_models
from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens
from diffusion_e2e_ft_tpu_torch.ops import image as im
from diffusion_e2e_ft_tpu_torch.ops import noise as noise_ops
from diffusion_e2e_ft_tpu_torch.ops import scheduler as sched_ops
from diffusion_e2e_ft_tpu_torch.parallel.mesh import frozen_copy, mesh_replicas, run_members
from diffusion_e2e_ft_tpu_torch.pipelines.marigold import init_random_
from diffusion_e2e_ft_tpu_torch.utils import trace

DOMAINS = ("indoor", "outdoor", "object")


def domain_one_hot(domain: str) -> np.ndarray:
    if domain not in DOMAINS:
        raise ValueError(f"Unknown domain {domain!r}; expected one of {DOMAINS}")
    v = np.zeros((3,), np.float32)
    v[DOMAINS.index(domain)] = 1.0
    return v


def switcher_embedding(domain_vec, batch: int = 1) -> torch.Tensor:
    """[2B, 10] fp32 class vector: sin/cos of the geometric one-hots ([0, 1]
    depth branch, [1, 0] normal branch) ++ sin/cos of the 3-dim domain one-hot."""
    geo = torch.tensor([[0.0, 1.0], [1.0, 0.0]])  # [depth; normal]
    geo_emb = torch.cat([torch.sin(geo), torch.cos(geo)], dim=-1).repeat_interleave(batch, dim=0)  # [2B, 4]
    dom = torch.as_tensor(np.asarray(domain_vec, np.float32)).reshape(1, 3)
    dom_emb = torch.cat([torch.sin(dom), torch.cos(dom)], dim=-1).expand(2 * batch, 6)
    return torch.cat([geo_emb, dom_emb], dim=-1)


@dataclasses.dataclass
class GeoWizardOutput:
    """Depth in [0, 1]; unit normals in [-1, 1]. The JAX package's fields, in its order."""

    depth_np: Optional[np.ndarray] = None
    depth_colored: Optional[np.ndarray] = None
    normal_np: Optional[np.ndarray] = None
    normal_colored: Optional[np.ndarray] = None
    uncertainty: Optional[np.ndarray] = None  # the depth ensemble's; None for a single member


class GeoWizardPipeline:
    """Joint depth + normal prediction from a GeoWizard-family checkpoint.

    Construct via `from_hf_dir` (published checkpoints) or `from_random`.
    Parameters are cast to `dtype` (bf16 or fp32) and moved to `device`, the
    card unless the caller asks for another."""

    latent_scale_factor = 0.18215

    def __init__(
        self,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        image_encoder: clip_models.CLIPVisionModelWithProjection,
        scheduler_config: sched_ops.SchedulerConfig,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        if unet.config.class_embed_proj_dim is None:
            raise ValueError("GeoWizardPipeline needs a UNet with a class embedding (UNetConfig.geowizard())")
        self.device = torch.device(device)
        self.dtype = dtype
        self.unet = unet.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.vae = vae.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.image_encoder = image_encoder.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.scheduler_config = scheduler_config
        self.schedule = sched_ops.make_schedule(scheduler_config, device=self.device)
        self._mesh, self._replicas = None, None  # with_mesh's mesh and replicas, in mesh order

    def with_mesh(self, mesh) -> "GeoWizardPipeline":
        """Split each call's ensemble members over `mesh`, as
        `MarigoldPipeline.with_mesh`; a member's depth / normal task pair
        stays on one device (joint attention couples it)."""
        self._mesh = mesh
        self._replicas = None if mesh is None else mesh_replicas(self, mesh, self._replica_on)
        return self

    def _replica_on(self, device: torch.device) -> "GeoWizardPipeline":
        rep = copy.copy(self)
        rep.device, rep._mesh, rep._replicas = device, None, None
        rep.unet, rep.vae = frozen_copy(self.unet, device), frozen_copy(self.vae, device)
        rep.image_encoder = frozen_copy(self.image_encoder, device)
        rep.schedule = sched_ops.make_schedule(self.scheduler_config, device=device)
        return rep

    def _infer_members(self, rgb, domain, num_steps, latent0) -> Tuple[torch.Tensor, torch.Tensor]:
        """`infer` over a chunk of members, split over the mesh when there is one."""
        if self._replicas is None:
            return self.infer(rgb, domain, num_steps, latent0)
        return run_members(self._replicas, self._mesh, latent0,
                           lambda rep, shard: rep.infer(rgb, domain, num_steps, shard), self.device)

    @classmethod
    def from_hf_dir(cls, path: str, device="cuda", dtype=torch.float32) -> "GeoWizardPipeline":
        from diffusion_e2e_ft_tpu_torch.pipelines import loading

        return loading.load_geowizard_pipeline(path, device=device, dtype=dtype)

    @classmethod
    def from_random(
        cls,
        unet_config: Optional[UNetConfig] = None,
        vae_config: Optional[VAEConfig] = None,
        vision_config: Optional[clip_models.CLIPVisionConfig] = None,
        scheduler_config: Optional[sched_ops.SchedulerConfig] = None,
        seed: int = 0,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ) -> "GeoWizardPipeline":
        """Random-weight pipeline (tiny by default, as the JAX `from_random`).
        Weights are drawn on the CPU from `seed`, so the same seed gives the
        same model on every device."""
        ucfg = unet_config or UNetConfig.tiny(class_embed_proj_dim=10, joint_attention=True)
        vcfg = vae_config or VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
        viscfg = vision_config or clip_models.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            image_size=224, patch_size=32, projection_dim=ucfg.cross_attention_dim,
        )
        gen = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            modules = UNet2DCondition(ucfg), AutoencoderKL(vcfg), clip_models.CLIPVisionModelWithProjection(viscfg)
        modules = [m.to_empty(device="cpu") for m in modules]
        for m in modules:
            init_random_(m, gen)
        return cls(*modules, scheduler_config or sched_ops.SchedulerConfig(), device=device, dtype=dtype)

    @trace.traced("infer")
    @torch.inference_mode()
    def infer(
        self, rgb: torch.Tensor, domain: str = "indoor", num_steps: int = 1, latent0: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """rgb [N,H,W,3] in [-1,1] -> (depth [N,H,W] in [0,1], unit normals
        [N,H,W,3] in GeoWizard's sign convention), fp32, one row a member.
        `latent0` [N,4,h,w] is each member's initial latent (None: zeros),
        shared by its depth and normal halves; an rgb batch of 1 is encoded
        once and shared by the members."""
        cfg = self.scheduler_config
        plan = sched_ops.make_plan(cfg, num_steps)
        rgb = rgb.to(self.device, torch.float32)
        rgb_latent = self.vae.encode_mean(rgb.to(self.dtype).permute(0, 3, 1, 2)) * self.latent_scale_factor
        latent0 = torch.zeros_like(rgb_latent) if latent0 is None else latent0.to(self.device, self.dtype)
        n = latent0.shape[0]
        rgb_latent = rgb_latent.expand(n, -1, -1, -1)
        rgb_latent2 = torch.cat([rgb_latent, rgb_latent])  # [2N, ...]: depth half, normal half
        embed = self.image_encoder(clip_models.clip_preprocess((rgb + 1.0) / 2.0))[:, None, :]  # [N or 1, 1, D]
        embed = embed.expand(n, -1, -1)
        context = torch.cat([embed, embed]).to(self.dtype)
        class_vec = switcher_embedding(domain_one_hot(domain), batch=n).to(self.device)
        latent = torch.cat([latent0, latent0])
        x0 = None
        for t, prev_t in zip(plan.timesteps.tolist(), plan.prev_timesteps.tolist()):
            model_out = self.unet(torch.cat([rgb_latent2, latent], dim=1), t, context, class_vec)
            with trace.span("scheduler"):
                out = sched_ops.ddim_step(cfg, self.schedule, model_out.float(), t, prev_t, latent.float())
                latent, x0 = out.prev_sample.to(self.dtype), out.pred_original_sample
        decoded = self.vae.decode(x0.to(self.dtype) / self.latent_scale_factor).float()
        decoded = decoded.permute(0, 2, 3, 1)  # [2N, H, W, 3]
        depth_dec, normal_dec = decoded[:n], decoded[n:]
        depth = (depth_dec.mean(dim=-1).clamp(-1.0, 1.0) + 1.0) / 2.0
        normal = -normal_dec / (normal_dec.norm(dim=-1, keepdim=True) + 1e-5)  # GeoWizard's sign flip
        return depth, normal

    @torch.inference_mode()
    def __call__(
        self,
        image: np.ndarray,  # [H, W, 3] uint8/float RGB
        denoising_steps: int = 1,
        ensemble_size: int = 1,
        processing_res: int = 768,
        match_input_res: bool = True,
        batch_size: int = 1,
        noise: str = "zeros",
        domain: str = "indoor",
        seed: Optional[int] = None,
        color_map: Optional[str] = "Spectral",
        ensemble_kwargs: Optional[dict] = None,
    ) -> GeoWizardOutput:
        """The JAX package's arguments, in its order. `seed` (default 0)
        seeds the generator of the noise; `batch_size` members run a device
        call (the JAX default, 1); `ensemble_kwargs` go to `ensemble_depths`."""
        with trace.request(self.device):
            with trace.span("pre"):
                if denoising_steps < 1 or ensemble_size < 1:
                    raise ValueError("denoising_steps and ensemble_size must be >= 1")
                img = np.asarray(image)
                if img.ndim != 3 or img.shape[-1] != 3:
                    raise ValueError(f"Expected [H, W, 3] RGB image, got {img.shape}")
                orig_hw = tuple(img.shape[:2])

                rgb = torch.from_numpy(img.astype(np.float32)).to(self.device)
                if processing_res > 0:
                    rgb = im.resize_max_res(rgb, processing_res)
                rgb = im.normalize_rgb(rgb)[None]
                latent_shape = (self.vae.config.latent_channels, rgb.shape[1] // 8, rgb.shape[2] // 8)
                generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else seed)
                batch_size = max(1, batch_size)
                latents = [noise_ops.member_draws(noise, generator, min(batch_size, ensemble_size - start),
                                                  latent_shape, dtype=self.dtype)[0]
                           for start in range(0, ensemble_size, batch_size)]
            depths, normals = zip(*(self._infer_members(rgb, domain, denoising_steps, z) for z in latents))
            depth_preds, normal_preds = torch.cat(depths), torch.cat(normals)

            with trace.span("post"):
                uncertainty = None
                if ensemble_size > 1:
                    depth, uncertainty = ens.ensemble_depths(depth_preds, **(ensemble_kwargs or {}))
                    normal = ens.ensemble_normals(normal_preds)
                    uncertainty = uncertainty.cpu().numpy()
                else:
                    depth, normal = depth_preds[0], normal_preds[0]

                depth = (depth - depth.min()) / (depth.max() - depth.min()).clamp_min(1e-8)  # min-max to [0, 1]
                if match_input_res and tuple(depth.shape) != orig_hw:
                    depth = im.resize(depth[..., None], orig_hw, method="bicubic")[..., 0]
                    normal = im.resize(normal, orig_hw, method="nearest")
                depth = depth.clamp(0.0, 1.0).cpu().numpy()
                normal = normal.clamp(-1.0, 1.0).cpu().numpy()
                colored = None
                if color_map is not None:
                    colored = (im.colorize_depth(depth, 0.0, 1.0, cmap=color_map) * 255).astype(np.uint8)
                return GeoWizardOutput(depth_np=depth, depth_colored=colored, normal_np=normal,
                                       normal_colored=im.colorize_normals(normal), uncertainty=uncertainty)
