"""Marigold on the SDXL-base UNet: the SDXL UNet (8 input channels,
transformer stacks 1 / 2 / 10 deep, the text-time added embedding) between
the SDXL VAE's encode and decode, a few trailing-DDIM steps a request.
Served through `cli/serve.py::PipelineService.predict` over a
`MarigoldPipeline`, as `families/marigold.py` serves SD2.

The port's UNet and VAE are built from the configuration file's groups by
the port's own HF readers (`pipelines/loading.py`), which know depth lists,
the added embedding and the VAE's scaling factor; the weights are the seeded
tensors of `reference/sdxl.py`'s parameter plan, drawn as the other
families draw theirs. The empty prompt's context and pooled embedding are
one seeded draw from the text-context stream, split in two."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from families import common as C
from lib import weights as W
from reference import models as ref
from reference import sdxl
from reference.precision import Precision
from work import count as work_count

KINDS = ["unet", "vae"]


def module_state(cfg: dict, kind: str, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        plan = ref.parameter_plan(sdxl.build(kind, cfg[kind]))
    return W.make_state(plan, seed, W.MODULE_STREAMS[kind], device, dtype)


def port_module(cfg: dict, kind: str, seed: int, device, dtype) -> torch.nn.Module:
    from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition
    from diffusion_e2e_ft_tpu_torch.pipelines import loading

    with torch.device("meta"):
        if kind == "unet":
            m = UNet2DCondition(loading.unet_config_from_hf(cfg["unet"]))
        else:
            m = AutoencoderKL(loading.vae_config_from_hf(cfg["vae"]))
    m.load_state_dict(module_state(cfg, kind, seed, device, dtype), strict=True, assign=True)
    return m


def text_embeds(cfg: dict, seed: int, device, dtype):
    """The seeded stand-ins for the empty prompt's context [1, L, D] and pooled embedding [1, E]."""
    shapes = [tuple(cfg["text_context_shape"]), tuple(cfg["pooled_text_shape"])]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = W.normal((sum(sizes),), seed, W.MODULE_STREAMS["text_context"], device, dtype)
    context, pooled = flat.split(sizes)
    return context.view(shapes[0]), pooled.view(shapes[1])


def build_serving(cell, seed: int, device) -> C.Served:
    from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    cfg, s = cell.config, cell.config["serve"]
    dtype = C.DTYPES[s["dtype"]]
    unet, vae = (port_module(cfg, k, seed, device, dtype) for k in KINDS)
    context, pooled = text_embeds(cfg, seed, device, dtype)
    pipe = MarigoldPipeline(unet, vae, C.port_scheduler(cfg), context, pooled_text_embed=pooled, device=device,
                            dtype=dtype)
    service = PipelineService(pipe, s["processing_res"], s["denoise_steps"])
    points = [(pipe, "infer", "infer", False, True), (pipe, "unet", "unet", True, False),
              (pipe.vae, "encode_mean", "encode", True, False), (pipe.vae, "decode", "decode", True, False)]
    return C.Served(lambda img: {"depth": service.predict(img, normals=False)}, points)


def reference_models(cfg: dict, seed: int, device, weight_dtype, prec: Precision) -> sdxl.Models:
    """The reference's float32 modules with the seeded weights drawn as the program's were."""
    with torch.device("meta"):
        m = sdxl.Models(cfg)
    for k in KINDS:
        sd = {n: t.float() for n, t in module_state(cfg, k, seed, device, weight_dtype).items()}
        getattr(m, k).load_state_dict(sd, strict=True, assign=True)
    return ref.set_precision(m, prec).requires_grad_(False)


def reference_serving(cell, seed: int, device, prec) -> Callable[[np.ndarray], Dict[str, np.ndarray]]:
    cfg = cell.config
    dtype = C.DTYPES[cfg["serve"]["dtype"]]
    m = reference_models(cfg, seed, device, dtype, prec)
    context, pooled = (t.float() for t in text_embeds(cfg, seed, device, dtype))

    @torch.no_grad()
    def call(image):
        return sdxl.request(m, cfg, context, pooled, image)

    return call


def serve_work(cell, hw):
    """The reference's work of one request at the processing size hw: the
    VAE's encode and decode, and the UNet's call counted once and taken once
    a step (every step calls it at the same shapes; the steps' own updates
    are elementwise, which the count leaves out as it does everywhere)."""
    cfg = cell.config
    with torch.device("meta"):
        m = sdxl.Models(cfg).requires_grad_(False)
    context = torch.empty(cfg["text_context_shape"], device="meta")
    pooled = torch.empty(cfg["pooled_text_shape"], device="meta")
    rgb = torch.empty((1, *hw, 3), device="meta")
    latent = []

    def vae():
        latent.append(m.vae.encode_mean(rgb.permute(0, 3, 1, 2)))
        m.vae.decode(latent[0])

    with torch.no_grad():
        coder = work_count.count(vae, m)
        unet_in, ids = torch.cat([latent[0], latent[0]], dim=1), sdxl.time_ids(hw, "meta")
        step = work_count.count(lambda: m.unet(unet_in, 0, context, pooled, ids), m)
    steps = cfg["serve"]["denoise_steps"]
    return work_count.Work(**{f.name: getattr(coder, f.name) + steps * getattr(step, f.name)
                              for f in dataclasses.fields(work_count.Work)})
