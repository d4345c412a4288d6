"""Marigold-style depth / surface-normal inference, port of
`diffusion_e2e_ft_tpu/pipelines/marigold.py`.

The device body (`infer`) is VAE encode -> a Python loop over the timestep
plan (UNet, then a DDIM, ancestral DDPM or latent-consistency step) -> VAE
decode -> task postprocessing. With one step and zeros noise, the production
configuration, that is one feed-forward pass. PyTorch runs it eagerly; there
is nothing to compile. The body takes its random draws explicitly (each
member's initial latent, and one noise tensor a step for the stochastic
schedulers); `__call__` draws them member by member from a `torch.Generator`
seeded with `seed`, runs the ensemble in chunks of `batch_size` members
batched natively (the JAX package maps a batch-1 graph over them, for a TPU
layout problem), and ensembles the members (`ops/ensemble.py`) with their
uncertainty. `with_mesh` splits each chunk's members over several devices.
Under a profiler session `__call__` records the spans of `utils/trace.py`:
`request` ⊃ `pre` (to the device body), each chunk's `infer` (⊃ `encode`,
each step's `unet` and `scheduler`, `decode`), `post`.

An SDXL-shaped UNet (`UNetConfig.sdxl()`, the "text_time" added embedding)
takes the pooled text embedding given at construction and the time ids
(H, W, 0, 0, H, W) of the processing size, made once a size; the latents
are scaled by the VAE's own `scaling_factor` (SD 0.18215, SDXL 0.13025).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens
from diffusion_e2e_ft_tpu_torch.ops import image as im
from diffusion_e2e_ft_tpu_torch.ops import noise as noise_ops
from diffusion_e2e_ft_tpu_torch.ops import scheduler as sched_ops
from diffusion_e2e_ft_tpu_torch.parallel.mesh import frozen_copy, mesh_replicas, run_members
from diffusion_e2e_ft_tpu_torch.utils import trace

# max_res: members a call, from `perf/torch_batch_sweep.py` (bf16, 10 DDIM steps) on an NVIDIA H100 80GB HBM3
# at 700 W: the least ms a member with a peak under 39.6 GiB (PERF.md, "Ensemble batch sweep")
_BATCH_TABLE = {512: 16, 768: 12, 1024: 8, 1536: 3}

@dataclasses.dataclass
class MarigoldOutput:
    """Depth in [0, 1]; normals in [-1, 1]. The JAX package's fields, in its
    order; `uncertainty` (a depth ensemble's, at the processing resolution)
    stays None for a single member and for normals."""

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

    def __init__(
        self,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        scheduler_config: sched_ops.SchedulerConfig,
        empty_text_embed,  # [1, L, cross_attention_dim]
        *,
        pooled_text_embed=None,  # [1, E]: the empty prompt's pooled embedding, for a "text_time" UNet only
        device="cuda",
        dtype: torch.dtype = torch.float32,
        scheduler_type: str = "ddim",
    ):
        if scheduler_type not in ("ddim", "ddpm", "lcm"):
            raise ValueError(f"Unknown scheduler_type {scheduler_type!r}; expected ddim, ddpm or lcm")
        self.scheduler_type = scheduler_type
        self.device = torch.device(device)
        self.dtype = dtype
        self.unet = unet.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.vae = vae.to(device=self.device, dtype=dtype).eval().requires_grad_(False)
        self.scheduler_config = scheduler_config
        self.schedule = sched_ops.make_schedule(scheduler_config, device=self.device)
        self.empty_text_embed = torch.as_tensor(empty_text_embed).to(self.device, dtype)
        if (getattr(unet, "add_embedding", None) is None) != (pooled_text_embed is None):
            raise ValueError("a pooled text embedding goes with a UNet with the text-time embedding, and only there")
        self.pooled_text_embed = (
            None if pooled_text_embed is None else torch.as_tensor(pooled_text_embed).to(self.device, dtype)
        )
        self._time_ids = {}  # (h, w) -> [1, 6] float32 on the device
        self._mesh, self._replicas = None, None  # with_mesh's mesh and replicas, in mesh order

    @property
    def latent_scale_factor(self) -> float:
        return self.vae.config.scaling_factor

    def _added_cond(self, hw, batch: int) -> dict:
        """The UNet's added-embedding inputs for a processing size: none, or
        the pooled text embedding and the time ids (original size, crop
        origin, target size, all the processing size)."""
        if self.pooled_text_embed is None:
            return {}
        hw = tuple(hw)
        if hw not in self._time_ids:
            self._time_ids[hw] = torch.tensor([[*hw, 0, 0, *hw]], dtype=torch.float32, device=self.device)
        return {"text_embeds": self.pooled_text_embed.expand(batch, -1),
                "time_ids": self._time_ids[hw].expand(batch, -1)}

    def with_mesh(self, mesh) -> "MarigoldPipeline":
        """Split each call's ensemble members over `mesh` (`parallel.make_mesh`):
        one replica of the modules per mesh device (the pipeline itself on its
        own device; a repeated device shares one), each device runs its block
        of a chunk's members, and the results are gathered in member order.
        The draws are made for all members first, as without a mesh, so the
        output does not depend on the mesh; a chunk whose member count does
        not divide by the mesh size runs whole on the first device (what the
        JAX `shard_batch` replication computes). None drops the mesh."""
        self._mesh = mesh
        self._replicas = None if mesh is None else mesh_replicas(self, mesh, self._replica_on)
        return self

    def _replica_on(self, device: torch.device) -> "MarigoldPipeline":
        rep = copy.copy(self)
        rep.device, rep._mesh, rep._replicas = device, None, None
        rep.unet, rep.vae = frozen_copy(self.unet, device), frozen_copy(self.vae, device)
        rep.schedule = sched_ops.make_schedule(self.scheduler_config, device=device)
        rep.empty_text_embed = self.empty_text_embed.to(device)
        rep.pooled_text_embed = None if self.pooled_text_embed is None else self.pooled_text_embed.to(device)
        rep._time_ids = {}
        return rep

    def _infer_members(self, rgb, num_steps, normals, latent0, step_noise) -> torch.Tensor:
        """`infer` over a chunk of members, split over the mesh when there is one."""
        if self._replicas is None:
            return self.infer(rgb, num_steps, normals, latent0, step_noise)
        return run_members(self._replicas, self._mesh, {"latent0": latent0, "step_noise": step_noise}, lambda rep, m:
                           rep.infer(rgb, num_steps, normals, m["latent0"], m["step_noise"]), self.device)

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
        scheduler_type: str = "ddim",
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
            device=device, dtype=dtype, scheduler_type=scheduler_type,
        )

    def step_noises(self, num_steps: int) -> int:
        """How many step-noise tensors a `num_steps` run takes: one a step for
        the stochastic schedulers (multi-step DDPM, LCM), else none."""
        return num_steps if self.scheduler_type in ("ddpm", "lcm") and num_steps > 1 else 0

    @trace.traced("infer")
    @torch.inference_mode()
    def infer(
        self, rgb: torch.Tensor, num_steps: int = 1, normals: bool = False,
        latent0: Optional[torch.Tensor] = None, step_noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """rgb [B,H,W,3] in [-1,1] -> depth [B,H,W] in [0,1] or unit normals
        [B,H,W,3] (fp32), one row a member.

        `latent0` [B,4,h,w] is each member's initial latent (None: zeros); an
        rgb batch of 1 is encoded once and shared by the members. The
        stochastic schedulers take `step_noise`, `step_noises(num_steps)`
        tensors shaped as `latent0`, one a step."""
        cfg = self.scheduler_config
        lcm = self.scheduler_type == "lcm"
        plan = sched_ops.make_lcm_plan(cfg, num_steps) if lcm else sched_ops.make_plan(cfg, num_steps)
        stochastic = self.step_noises(num_steps) > 0
        if stochastic and (step_noise is None or len(step_noise) != num_steps):
            raise ValueError(f"{num_steps}-step {self.scheduler_type} takes step_noise: one tensor a step")
        x = rgb.to(self.device, self.dtype).permute(0, 3, 1, 2)
        rgb_latent = self.vae.encode_mean(x) * self.latent_scale_factor
        latent = torch.zeros_like(rgb_latent) if latent0 is None else latent0.to(self.device, self.dtype)
        b = latent.shape[0]
        rgb_latent = rgb_latent.expand(b, -1, -1, -1)
        context = self.empty_text_embed.expand(b, -1, -1)
        added = self._added_cond(x.shape[2:], b)
        x0 = None
        for i, (t, prev_t) in enumerate(zip(plan.timesteps.tolist(), plan.prev_timesteps.tolist())):
            model_out = self.unet(torch.cat([rgb_latent, latent], dim=1), t, context, **added).float()
            with trace.span("scheduler"):
                args = (cfg, self.schedule, model_out, t, prev_t, latent.float())
                if lcm:
                    out = sched_ops.lcm_step(*args, noise=step_noise[i] if stochastic else None,
                                             is_last=i == num_steps - 1)
                elif stochastic:
                    out = sched_ops.ddpm_step(*args, noise=step_noise[i])
                else:
                    out = sched_ops.ddim_step(*args)
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
        """The JAX package's arguments, in its order. `seed` (default 0)
        seeds the generator of the noise; `batch_size` members run a device
        call (< 1: `find_batch_size`); `ensemble_kwargs` go to
        `ensemble_depths`."""
        with trace.request(self.device):
            with trace.span("pre"):
                if denoising_steps < 1:
                    raise ValueError("denoising_steps must be >= 1")
                if ensemble_size < 1:
                    raise ValueError("ensemble_size must be >= 1")
                img = np.asarray(image)
                if img.ndim != 3 or img.shape[-1] != 3:
                    raise ValueError(f"Expected [H, W, 3] RGB image, got {img.shape}")
                orig_hw = tuple(img.shape[:2])

                rgb = torch.from_numpy(img.astype(np.float32)).to(self.device)
                if processing_res > 0:
                    rgb = im.resize_max_res(rgb, processing_res, method=resample_method)
                rgb = im.normalize_rgb(rgb)[None]
                latent_shape = (self.vae.config.latent_channels, rgb.shape[1] // 8, rgb.shape[2] // 8)
                generator = torch.Generator(device=self.device).manual_seed(0 if seed is None else seed)
                if batch_size < 1:
                    batch_size = self.find_batch_size(ensemble_size, max(rgb.shape[1:3]))
                draws = [noise_ops.member_draws(noise, generator, min(batch_size, ensemble_size - start), latent_shape,
                                                self.step_noises(denoising_steps), self.dtype)
                         for start in range(0, ensemble_size, batch_size)]
            preds = torch.cat([self._infer_members(rgb, denoising_steps, normals, *d) for d in draws])  # [E, H, W(, 3)]

            with trace.span("post"):
                if normals:
                    normal = ens.ensemble_normals(preds) if ensemble_size > 1 else preds[0]
                    normal = normal / (normal.norm(dim=-1, keepdim=True) + 1e-5)
                    if match_input_res and tuple(normal.shape[:2]) != orig_hw:
                        normal = im.resize(normal, orig_hw, method=resample_method)
                        normal = normal / (normal.norm(dim=-1, keepdim=True) + 1e-5)
                    normal = normal.clamp(-1.0, 1.0).cpu().numpy()
                    colored = im.colorize_normals(normal) if color_map is not None else None
                    return MarigoldOutput(normal_np=normal, normal_colored=colored)

                uncertainty = None
                if ensemble_size > 1:
                    depth, uncertainty = ens.ensemble_depths(preds, **(ensemble_kwargs or {}))
                    uncertainty = uncertainty.cpu().numpy()
                else:
                    depth = preds[0]
                depth = (depth - depth.min()) / (depth.max() - depth.min()).clamp_min(1e-8)  # min-max to [0, 1]
                if match_input_res and tuple(depth.shape) != orig_hw:
                    depth = im.resize(depth[..., None], orig_hw, method=resample_method)[..., 0]
                depth = depth.clamp(0.0, 1.0).cpu().numpy()
                colored = None
                if color_map is not None:
                    colored = (im.colorize_depth(depth, 0.0, 1.0, cmap=color_map) * 255).astype(np.uint8)
                return MarigoldOutput(depth_np=depth, depth_colored=colored, uncertainty=uncertainty)

    @staticmethod
    def find_batch_size(ensemble_size: int, max_res: int) -> int:
        """Members a device call, by the processing resolution's longer side,
        capped at the ensemble size: the batch with the least bf16 time a
        member among those whose peak stays under half of an 80 GB card.

        The rows up to 1536 are measured by `perf/torch_batch_sweep.py` on
        an H100 (PERF.md, "Ensemble batch sweep"); a resolution takes the
        row of the next swept one up. At 512 the largest batch swept (16) is
        still the fastest, so the optimum may lie above it. Beyond 1536 the
        batch is an extrapolation, not measured: the peak grows about
        linearly in pixels x members, so the 1536 row's batch shrinks with
        the pixel count."""
        for res, bs in _BATCH_TABLE.items():
            if max_res <= res:
                break
        else:
            bs = int(bs * (res / max_res) ** 2)
        return max(1, min(bs, ensemble_size))
