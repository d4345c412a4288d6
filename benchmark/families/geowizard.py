"""GeoWizard E2E-FT: an SD1.5-shaped UNet with a projection class embedding
(the task and domain switcher) and joint cross-task self-attention, the SD
VAE, and the CLIP ViT-L/14 image tower. Served through
`pipelines/geowizard.py::GeoWizardPipeline.__call__` with
`cli/run_geowizard.py`'s defaults (no file written); trained by
`training/geowizard.py::GeoWizardTrainer`."""

from __future__ import annotations

import torch

from families import common as C
from reference import pipeline as rp
from work import count as work_count

KINDS = ["unet", "vae", "image_encoder"]


def build_serving(cell, seed: int, device) -> C.Served:
    from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import GeoWizardPipeline

    cfg, s = cell.config, cell.config["serve"]
    dtype = C.DTYPES[s["dtype"]]
    unet, vae, enc = (C.port_module(cfg, k, seed, device, dtype) for k in KINDS)
    pipe = GeoWizardPipeline(unet, vae, enc, C.port_scheduler(cfg), device=device, dtype=dtype)

    def call(img):
        out = pipe(img, denoising_steps=s["denoise_steps"], ensemble_size=1, processing_res=s["processing_res"],
                   match_input_res=True, noise="zeros", domain=s["domain"], seed=None, color_map=s["color_map"])
        return {"depth": out.depth_np, "normal": out.normal_np}

    points = [(pipe, "infer", "infer", False, True), (pipe, "unet", "unet", True, False),
              (pipe, "image_encoder", "image_encoder", True, False),
              (pipe.vae, "encode_mean", "encode", True, False), (pipe.vae, "decode", "decode", True, False)]
    return C.Served(call, points)


def reference_serving(cell, seed: int, device, prec):
    cfg, s = cell.config, cell.config["serve"]
    m = C.reference_models(cfg, KINDS, seed, device, C.DTYPES[s["dtype"]], prec)

    @torch.no_grad()
    def call(image):
        return rp.geowizard_request(m, cfg["scheduler"], image, s["processing_res"], s["domain"])

    return call


def serve_work(cell, hw):
    cfg = cell.config
    m = C.meta_models(cfg, KINDS)
    rgb = torch.empty((1, *hw, 3), device="meta")
    with torch.no_grad():
        return work_count.count(lambda: rp.geowizard_pair(m, cfg["scheduler"], rgb, cfg["serve"]["domain"]), m)


# ----------------------------------------------------------------------------- training


def build_training(cell, seed: int, device):
    from diffusion_e2e_ft_tpu_torch.training.geowizard import GeoWizardTrainer

    cfg = cell.config
    unet, vae, enc = (C.port_module(cfg, k, seed, device, torch.float32) for k in KINDS)
    return GeoWizardTrainer(C.train_config(cfg, cell.params, "joint"), unet, vae, enc, C.port_scheduler(cfg),
                            compute_dtype=C.compute_dtype(cfg))


def train_ring(cell, seed: int):
    return C.train_ring(cell.params, seed, normals=True)


def _groups(m, mult: float):
    names = [n for n, _ in m.unet.named_parameters()]
    cls = [n for n in names if "class_embedding" in n.split(".")]
    if mult == 1.0:
        return [(names, 1.0)]
    return [([n for n in names if n not in cls], 1.0), (cls, mult)]


def reference_training(cell, seed: int, device, prec):
    cfg, hp = cell.config, cell.config["train"]
    m = C.reference_models(cfg, KINDS, seed, device, torch.float32, prec)
    m.unet.requires_grad_(True)

    def block_loss_sums(batch, rows):
        rgb, mask, depth, normal = (torch.as_tensor(batch[k][rows]).to(device)
                                    for k in ("rgb", "val_mask", "depth_target", "normal_target"))
        return list(rp.geowizard_loss_sums(m, cfg["scheduler"], rgb, mask, depth, normal, "indoor"))

    return m, block_loss_sums, [hp["ssi_weight"], hp["angular_weight"]], _groups(m, hp["class_embedding_lr_mult"])


def train_work(cell):
    cfg, p = cell.config, cell.params
    b, h, w = p["micro_batch"], p["height"], p["width"]
    m = C.meta_models(cfg, KINDS)
    m.unet.requires_grad_(True)
    rgb = torch.empty((b, h, w, 3), device="meta")
    depth, normal = torch.empty((b, h, w), device="meta"), torch.empty((b, h, w, 3), device="meta")
    mask = torch.empty((b, h, w), dtype=torch.bool, device="meta")

    def step():
        ssi, ang = rp.geowizard_loss_sums(m, cfg["scheduler"], rgb, mask, depth, normal, "indoor")
        (ssi + ang).backward()

    return work_count.count(step, m, vae_pairs=True)
