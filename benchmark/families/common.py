"""What the families share: the configuration file's groups mapped to the
program's config objects, the seeded weights of each module (the same
tensors for the program and, drawn again, for the reference), the
reference's modules, and the seeded training batches."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List

import numpy as np
import torch

from lib import weights as W
from reference import models as ref
from reference.precision import Precision

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class Served:
    """A served program: `call` takes an uint8 image and returns its answers as
    numpy arrays by name; `trace_points` are the callables a traced run wraps,
    as (owner, attribute, span name, CUDA events, synchronise)."""

    call: Callable[[np.ndarray], Dict[str, np.ndarray]]
    trace_points: list


def compute_dtype(cfg: dict):
    """The trainer's autocast dtype: None (no autocast) for float32."""
    dt = DTYPES[cfg["train"]["dtype"]]
    return None if dt == torch.float32 else dt


def plan(cfg: dict, kind: str):
    with torch.device("meta"):
        return ref.parameter_plan(ref.build(kind, cfg[kind]))


def module_state(cfg: dict, kind: str, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    return W.make_state(plan(cfg, kind), seed, W.MODULE_STREAMS[kind], device, dtype)


def port_module(cfg: dict, kind: str, seed: int, device, dtype) -> torch.nn.Module:
    """The program's module of `kind`, built on the meta device and given the seeded weights."""
    from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig, clip

    c = cfg[kind]
    with torch.device("meta"):
        if kind == "unet":
            levels = [t.startswith("CrossAttn") for t in c["down_block_types"]]
            heads = c["attention_head_dim"]
            heads = tuple(heads) if isinstance(heads, list) else (heads,) * len(c["block_out_channels"])
            m = UNet2DCondition(UNetConfig(
                in_channels=c["in_channels"], out_channels=c["out_channels"],
                block_out_channels=tuple(c["block_out_channels"]), layers_per_block=c["layers_per_block"],
                cross_attention_levels=tuple(levels), num_attention_heads=heads,
                cross_attention_dim=c["cross_attention_dim"], norm_num_groups=c["norm_num_groups"],
                norm_eps=c["norm_eps"], use_linear_projection=c["use_linear_projection"],
                flip_sin_to_cos=c["flip_sin_to_cos"], freq_shift=float(c["freq_shift"]),
                class_embed_proj_dim=c.get("projection_class_embeddings_input_dim"),
                joint_attention=c.get("joint_attention", False)))
        elif kind == "vae":
            m = AutoencoderKL(VAEConfig(
                in_channels=c["in_channels"], out_channels=c["out_channels"], latent_channels=c["latent_channels"],
                block_out_channels=tuple(c["block_out_channels"]), layers_per_block=c["layers_per_block"],
                norm_num_groups=c["norm_num_groups"]))
        else:
            m = clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig(
                hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                intermediate_size=c["intermediate_size"], image_size=c["image_size"], patch_size=c["patch_size"],
                projection_dim=c["projection_dim"], hidden_act=c["hidden_act"], layer_norm_eps=c["layer_norm_eps"]))
    m.load_state_dict(module_state(cfg, kind, seed, device, dtype), strict=True, assign=True)
    return m


def port_scheduler(cfg: dict):
    from diffusion_e2e_ft_tpu_torch.ops.scheduler import SchedulerConfig

    s = cfg["scheduler"]
    return SchedulerConfig(num_train_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
                           beta_end=s["beta_end"], beta_schedule=s["beta_schedule"],
                           prediction_type=s["prediction_type"], timestep_spacing=s["timestep_spacing"])


class Models(torch.nn.Module):
    """The reference's modules under one root (children unet, vae[, image_encoder])."""

    def __init__(self, cfg: dict, kinds: Iterable[str]):
        super().__init__()
        for k in kinds:
            setattr(self, k, ref.build(k, cfg[k]))
        self.clip_size = cfg.get("image_encoder", {}).get("image_size")


def reference_models(cfg: dict, kinds: List[str], seed: int, device, weight_dtype, prec: Precision) -> Models:
    """The reference's float32 modules with the seeded weights drawn as the program's
    were (in `weight_dtype`) and held in float32."""
    with torch.device("meta"):
        m = Models(cfg, kinds)
    for k in kinds:
        sd = {n: t.float() for n, t in module_state(cfg, k, seed, device, weight_dtype).items()}
        getattr(m, k).load_state_dict(sd, strict=True, assign=True)
    return ref.set_precision(m, prec).requires_grad_(False)


def meta_models(cfg: dict, kinds: List[str]) -> Models:
    with torch.device("meta"):
        return Models(cfg, kinds).requires_grad_(False)


def text_context(cfg: dict, seed: int, device, dtype) -> torch.Tensor:
    """The seeded stand-in for the CLIP embedding of the empty prompt, [1, L, D]."""
    return W.normal(tuple(cfg["text_context_shape"]), seed, W.MODULE_STREAMS["text_context"], device, dtype)


def train_ring(params: dict, seed: int, normals: bool) -> List[Dict[str, np.ndarray]]:
    """`ring` host batches as a loader delivers them: rgb [B, H, W, 3] in [-1, 1],
    val_mask [B, H, W] with `invalid_share` of the pixels invalid, a depth target
    in [-1, 1] (`target`, or `depth_target` with unit `normal_target` for joint
    training). Every row of every batch differs."""
    rng = np.random.default_rng([int(seed) % (1 << 64), W.MODULE_STREAMS["inputs"]])
    b, h, w = params["micro_batch"], params["height"], params["width"]
    ring = []
    for _ in range(params["ring"]):
        batch = {
            "rgb": rng.random((b, h, w, 3), dtype=np.float32) * 2.0 - 1.0,
            "val_mask": rng.random((b, h, w), dtype=np.float32) >= params["invalid_share"],
        }
        depth = rng.random((b, h, w), dtype=np.float32) * 2.0 - 1.0
        if normals:
            n = rng.standard_normal((b, h, w, 3), dtype=np.float32)
            batch.update(depth_target=depth, normal_target=n / np.linalg.norm(n, axis=-1, keepdims=True))
        else:
            batch["target"] = depth
        ring.append(batch)
    return ring


def train_config(cfg: dict, params: dict, modality: str):
    from diffusion_e2e_ft_tpu_torch.training.config import TrainConfig

    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    hp = {k: v for k, v in cfg["train"].items() if k in fields}
    return TrainConfig(modality=modality, train_batch_size=params["micro_batch"],
                       gradient_accumulation_steps=params["accumulation"], **hp)
