"""Marigold E2E-FT: an SD2 UNet (8 input channels) between the SD VAE's
encode and decode. Served through `cli/serve.py::PipelineService.predict`
over a `MarigoldPipeline`; trained by `training/trainer.py::E2ETrainer`."""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from families import common as C
from reference import pipeline as rp
from work import count as work_count

KINDS = ["unet", "vae"]


def build_serving(cell, seed: int, device) -> C.Served:
    from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    cfg, s = cell.config, cell.config["serve"]
    dtype = C.DTYPES[s["dtype"]]
    unet, vae = (C.port_module(cfg, k, seed, device, dtype) for k in KINDS)
    pipe = MarigoldPipeline(unet, vae, C.port_scheduler(cfg), C.text_context(cfg, seed, device, dtype),
                            device=device, dtype=dtype)
    service = PipelineService(pipe, s["processing_res"], s["denoise_steps"])
    points = [(pipe, "infer", "infer", False, True), (pipe, "unet", "unet", True, False),
              (pipe.vae, "encode_mean", "encode", True, False), (pipe.vae, "decode", "decode", True, False)]
    return C.Served(lambda img: {"depth": service.predict(img, normals=False)}, points)


def reference_serving(cell, seed: int, device, prec) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    cfg, s = cell.config, cell.config["serve"]
    dtype = C.DTYPES[s["dtype"]]
    m = C.reference_models(cfg, KINDS, seed, device, dtype, prec)
    context = C.text_context(cfg, seed, device, dtype).float()

    @torch.no_grad()
    def call(image):
        return rp.marigold_request(m, cfg["scheduler"], context, image, s["processing_res"])

    return call


def serve_work(cell, hw):
    """The reference's work of one request at the processing size hw."""
    cfg = cell.config
    m = C.meta_models(cfg, KINDS)
    context = torch.empty(cfg["text_context_shape"], device="meta")
    rgb = torch.empty((1, *hw, 3), device="meta")
    with torch.no_grad():
        return work_count.count(lambda: rp.marigold_depth(m, cfg["scheduler"], context, rgb), m)


# ----------------------------------------------------------------------------- training


def build_training(cell, seed: int, device):
    from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer

    cfg, p = cell.config, cell.params
    unet, vae = (C.port_module(cfg, k, seed, device, torch.float32) for k in KINDS)
    context = C.text_context(cfg, seed, device, torch.float32).cpu().numpy()
    trainer = E2ETrainer(C.train_config(cfg, p, "depth"), unet, vae, context, C.port_scheduler(cfg),
                         compute_dtype=C.compute_dtype(cfg))
    return trainer


def train_ring(cell, seed: int) -> List[dict]:
    return C.train_ring(cell.params, seed, normals=False)


def reference_training(cell, seed: int, device, prec):
    cfg = cell.config
    m = C.reference_models(cfg, KINDS, seed, device, torch.float32, prec)
    m.unet.requires_grad_(True)
    context = C.text_context(cfg, seed, device, torch.float32)

    def block_loss_sums(batch, rows):
        rgb, mask, target = (torch.as_tensor(batch[k][rows]).to(device) for k in ("rgb", "val_mask", "target"))
        return [rp.marigold_loss_sum(m, cfg["scheduler"], context, rgb, mask, target)]

    return m, block_loss_sums, [1.0], [(list(n for n, _ in m.unet.named_parameters()), 1.0)]


def train_work(cell):
    """The reference's work of one micro-step, its backward included."""
    cfg, p = cell.config, cell.params
    b, h, w = p["micro_batch"], p["height"], p["width"]
    m = C.meta_models(cfg, KINDS)
    m.unet.requires_grad_(True)
    context = torch.empty(cfg["text_context_shape"], device="meta")
    rgb, target = torch.empty((b, h, w, 3), device="meta"), torch.empty((b, h, w), device="meta")
    mask = torch.empty((b, h, w), dtype=torch.bool, device="meta")
    return work_count.count(
        lambda: rp.marigold_loss_sum(m, cfg["scheduler"], context, rgb, mask, target).backward(), m, vae_pairs=True)
