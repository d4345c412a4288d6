"""HF (diffusers-layout) pipeline directories, port of the Marigold and
GeoWizard parts of `diffusion_e2e_ft_tpu/pipelines/loading.py`.

Loading reads `unet/`, `vae/`, `scheduler/` and `text_encoder/` (Marigold) or
`image_encoder/` (GeoWizard) subfolders; weights load with
`load_state_dict(strict=True)`, so a missing or extra key fails. The
empty-prompt text embedding is computed once at load time and the text tower
is dropped afterwards. Entry points put the models on `cuda` unless given
another device.

`save_pipeline_dir` writes the same layout (torch `.bin` weights, which both
packages read), so an export from either package loads in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as clip_models
from diffusion_e2e_ft_tpu_torch.models import convert
from diffusion_e2e_ft_tpu_torch.ops import scheduler as sched_ops

WEIGHT_NAMES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _find_weights(subdir: str) -> str:
    for name in WEIGHT_NAMES:
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weights file in {subdir} (tried {WEIGHT_NAMES})")


def unet_config_from_hf(cfg: Dict[str, Any]) -> UNetConfig:
    """The UNet config of an HF `config.json`: a list `transformer_layers_per_block`
    gives each level its depth, and `addition_embed_type` "text_time" (SDXL)
    the added embedding over `projection_class_embeddings_input_dim` inputs.
    GeoWizard's joint attention is a runtime flag, not an HF field:
    `load_geowizard_pipeline` sets it."""
    down_types = cfg.get("down_block_types", ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8)
    if isinstance(heads, int):
        heads = (heads,) * len(down_types)
    depth = cfg.get("transformer_layers_per_block", 1)
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_levels=tuple("CrossAttn" in t for t in down_types),
        num_attention_heads=tuple(heads),
        cross_attention_dim=cfg.get("cross_attention_dim", 1024),
        transformer_depth=depth if isinstance(depth, int) else tuple(depth),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
        use_linear_projection=cfg.get("use_linear_projection", False),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
        class_embed_proj_dim=cfg.get("projection_class_embeddings_input_dim")
        if cfg.get("class_embed_type") == "projection"
        else None,
        addition_embed_type=cfg.get("addition_embed_type"),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim") or 256,
        addition_embed_input_dim=cfg.get("projection_class_embeddings_input_dim")
        if cfg.get("addition_embed_type")
        else None,
    )


def vae_config_from_hf(cfg: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def scheduler_config_from_hf(cfg: Dict[str, Any]) -> sched_ops.SchedulerConfig:
    return sched_ops.SchedulerConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "v_prediction"),
        timestep_spacing=cfg.get("timestep_spacing", "leading"),
        steps_offset=cfg.get("steps_offset", 1),
        clip_sample=cfg.get("clip_sample", False),
        clip_sample_range=cfg.get("clip_sample_range", 1.0),
        set_alpha_to_one=cfg.get("set_alpha_to_one", False),
        rescale_betas_zero_snr=cfg.get("rescale_betas_zero_snr", False),
        original_inference_steps=cfg.get("original_inference_steps", 50),
        timestep_scaling=cfg.get("timestep_scaling", 10.0),
    )


def unet_config_to_hf(c: UNetConfig) -> Dict[str, Any]:
    out = {
        "_class_name": "UNet2DConditionModel",
        "in_channels": c.in_channels,
        "out_channels": c.out_channels,
        "block_out_channels": list(c.block_out_channels),
        "layers_per_block": c.layers_per_block,
        "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D" for a in c.cross_attention_levels],
        "up_block_types": ["CrossAttnUpBlock2D" if a else "UpBlock2D" for a in reversed(c.cross_attention_levels)],
        "attention_head_dim": list(c.num_attention_heads),
        "cross_attention_dim": c.cross_attention_dim,
        "transformer_layers_per_block": c.transformer_depth if isinstance(c.transformer_depth, int)
        else list(c.transformer_depth),
        "norm_num_groups": c.norm_num_groups,
        "norm_eps": c.norm_eps,
        "use_linear_projection": c.use_linear_projection,
        "flip_sin_to_cos": c.flip_sin_to_cos,
        "freq_shift": c.freq_shift,
        "act_fn": "silu",
        "center_input_sample": False,
        "downsample_padding": 1,
        "mid_block_scale_factor": 1,
    }
    if c.class_embed_proj_dim is not None:
        out["class_embed_type"] = "projection"
        out["projection_class_embeddings_input_dim"] = c.class_embed_proj_dim
    if c.addition_embed_type is not None:
        out["addition_embed_type"] = c.addition_embed_type
        out["addition_time_embed_dim"] = c.addition_time_embed_dim
        out["projection_class_embeddings_input_dim"] = c.addition_embed_input_dim
    return out


def vae_config_to_hf(c: VAEConfig) -> Dict[str, Any]:
    n = len(c.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "in_channels": c.in_channels,
        "out_channels": c.out_channels,
        "latent_channels": c.latent_channels,
        "block_out_channels": list(c.block_out_channels),
        "layers_per_block": c.layers_per_block,
        "norm_num_groups": c.norm_num_groups,
        "scaling_factor": c.scaling_factor,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "act_fn": "silu",
    }


def scheduler_config_to_hf(c: sched_ops.SchedulerConfig, class_name: str = "DDIMScheduler") -> Dict[str, Any]:
    """The scheduler class's HF config; an LCM class also carries its
    distillation fields (`original_inference_steps`, `timestep_scaling`)."""
    lcm = {"original_inference_steps": c.original_inference_steps, "timestep_scaling": c.timestep_scaling}
    return {
        "_class_name": class_name,
        "num_train_timesteps": c.num_train_timesteps,
        "beta_start": c.beta_start,
        "beta_end": c.beta_end,
        "beta_schedule": c.beta_schedule,
        "prediction_type": c.prediction_type,
        "timestep_spacing": c.timestep_spacing,
        "steps_offset": c.steps_offset,
        "clip_sample": c.clip_sample,
        "clip_sample_range": c.clip_sample_range,
        "set_alpha_to_one": c.set_alpha_to_one,
        "rescale_betas_zero_snr": c.rescale_betas_zero_snr,
        **(lcm if "LCM" in class_name else {}),
        "trained_betas": None,
    }


def text_config_from_hf(cfg: Dict[str, Any]) -> clip_models.CLIPTextConfig:
    return clip_models.CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 1024),
        num_layers=cfg.get("num_hidden_layers", 23),
        num_heads=cfg.get("num_attention_heads", 16),
        intermediate_size=cfg.get("intermediate_size", 4096),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
    )


def text_config_to_hf(c: clip_models.CLIPTextConfig) -> Dict[str, Any]:
    return {
        "architectures": ["CLIPTextModel"],
        "model_type": "clip_text_model",
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers,
        "num_attention_heads": c.num_heads,
        "intermediate_size": c.intermediate_size,
        "max_position_embeddings": c.max_position_embeddings,
        "hidden_act": c.hidden_act,
        "layer_norm_eps": c.layer_norm_eps,
    }


def vision_config_from_hf(cfg: Dict[str, Any]) -> clip_models.CLIPVisionConfig:
    return clip_models.CLIPVisionConfig(
        hidden_size=cfg.get("hidden_size", 1024),
        num_layers=cfg.get("num_hidden_layers", 24),
        num_heads=cfg.get("num_attention_heads", 16),
        intermediate_size=cfg.get("intermediate_size", 4096),
        image_size=cfg.get("image_size", 224),
        patch_size=cfg.get("patch_size", 14),
        projection_dim=cfg.get("projection_dim", 768),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
    )


def vision_config_to_hf(c: clip_models.CLIPVisionConfig) -> Dict[str, Any]:
    return {
        "architectures": ["CLIPVisionModelWithProjection"],
        "model_type": "clip_vision_model",
        "hidden_size": c.hidden_size,
        "num_hidden_layers": c.num_layers,
        "num_attention_heads": c.num_heads,
        "intermediate_size": c.intermediate_size,
        "image_size": c.image_size,
        "patch_size": c.patch_size,
        "projection_dim": c.projection_dim,
        "hidden_act": c.hidden_act,
        "layer_norm_eps": c.layer_norm_eps,
    }


def _load_module(module_cls, config, weights_path: str) -> torch.nn.Module:
    """Build on the meta device and take the file's tensors as parameters."""
    state = convert.canonicalize_keys(convert.load_weights(weights_path))
    state = {k: v for k, v in state.items() if "position_ids" not in k}
    with torch.device("meta"):
        module = module_cls(config)
    module.load_state_dict(state, strict=True, assign=True)
    return module


def load_unet(path: str) -> UNet2DCondition:
    cfg = unet_config_from_hf(_read_json(os.path.join(path, "config.json")))
    return _load_module(UNet2DCondition, cfg, _find_weights(path))


def load_vae(path: str) -> AutoencoderKL:
    cfg = vae_config_from_hf(_read_json(os.path.join(path, "config.json")))
    return _load_module(AutoencoderKL, cfg, _find_weights(path))


def load_image_encoder(path: str) -> clip_models.CLIPVisionModelWithProjection:
    cfg = vision_config_from_hf(_read_json(os.path.join(path, "config.json")))
    return _load_module(clip_models.CLIPVisionModelWithProjection, cfg, _find_weights(path))


@torch.inference_mode()
def compute_empty_text_embed(text_encoder_dir: str, device="cuda", pad_to: Optional[int] = None) -> np.ndarray:
    """Run the checkpoint's text tower on the empty prompt once (EOS-padded to
    `pad_to` tokens if given); return [1, L, D] fp32."""
    cfg = text_config_from_hf(_read_json(os.path.join(text_encoder_dir, "config.json")))
    model = _load_module(clip_models.CLIPTextModel, cfg, _find_weights(text_encoder_dir))
    model = model.to(device=device, dtype=torch.float32).eval()
    ids = torch.as_tensor(clip_models.empty_prompt_ids(pad_to), device=device)
    return model(ids).cpu().numpy()


def load_marigold_pipeline(
    path: str, device="cuda", dtype: torch.dtype = torch.float32, allow_missing_text_encoder: bool = False
):
    """Assemble a MarigoldPipeline from an HF pipeline directory.

    The checkpoint's `text_encoder/` is required: the UNet was trained on the
    real CLIP empty-prompt embedding. `allow_missing_text_encoder=True`, for
    synthetic checkpoints only, substitutes zeros with a warning."""
    from diffusion_e2e_ft_tpu_torch.pipelines.marigold import MarigoldPipeline

    unet = load_unet(os.path.join(path, "unet"))
    vae = load_vae(os.path.join(path, "vae"))
    sched_json = _read_json(os.path.join(path, "scheduler", "scheduler_config.json"))
    cls_name = sched_json.get("_class_name", "")
    scheduler_type = "lcm" if "LCM" in cls_name else ("ddpm" if "DDPM" in cls_name else "ddim")
    te_dir = os.path.join(path, "text_encoder")
    if os.path.isdir(te_dir):
        empty = compute_empty_text_embed(te_dir, device=device)
    elif allow_missing_text_encoder:
        warnings.warn(
            f"{path} has no text_encoder/ subfolder; substituting a ZEROS empty-text "
            "embedding. Inference will NOT reproduce the trained model's outputs.",
            stacklevel=2,
        )
        empty = np.zeros((1, 2, unet.config.cross_attention_dim), np.float32)
    else:
        raise FileNotFoundError(
            f"{path} has no text_encoder/ subfolder. The empty-prompt CLIP embedding is part "
            "of the model; pass allow_missing_text_encoder=True only for synthetic checkpoints."
        )
    return MarigoldPipeline(
        unet, vae, scheduler_config_from_hf(sched_json), empty,
        device=device, dtype=dtype, scheduler_type=scheduler_type,
    )


def load_geowizard_pipeline(path: str, device="cuda", dtype: torch.dtype = torch.float32):
    """Assemble a GeoWizardPipeline from an HF pipeline directory with an
    `image_encoder/` (CLIP vision tower + projection). A UNet with a class
    embedding runs joint attention, as the JAX loader sets it."""
    from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import GeoWizardPipeline

    unet_dir = os.path.join(path, "unet")
    ucfg = unet_config_from_hf(_read_json(os.path.join(unet_dir, "config.json")))
    ucfg = dataclasses.replace(ucfg, joint_attention=ucfg.class_embed_proj_dim is not None)
    unet = _load_module(UNet2DCondition, ucfg, _find_weights(unet_dir))
    vae = load_vae(os.path.join(path, "vae"))
    encoder = load_image_encoder(os.path.join(path, "image_encoder"))
    sched = scheduler_config_from_hf(_read_json(os.path.join(path, "scheduler", "scheduler_config.json")))
    return GeoWizardPipeline(unet, vae, encoder, sched, device=device, dtype=dtype)


_MODEL_INDEX_CLASSES = {
    "text_encoder": ["transformers", "CLIPTextModel"],
    "tokenizer": ["transformers", "CLIPTokenizer"],
    "image_encoder": ["transformers", "CLIPVisionModelWithProjection"],
    "feature_extractor": ["transformers", "CLIPImageProcessor"],
}


def _save_weights(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    torch.save({k: v.detach().to("cpu", torch.float32).contiguous() for k, v in state_dict.items()}, path)


def save_text_encoder(path: str, config: clip_models.CLIPTextConfig, state_dict: Mapping[str, torch.Tensor]) -> None:
    """A `text_encoder/` subfolder: config.json and fp32 `pytorch_model.bin`
    in the transformers layout, which `compute_empty_text_embed` reads."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(text_config_to_hf(config), f, indent=2)
    _save_weights(state_dict, os.path.join(path, "pytorch_model.bin"))


def save_pipeline_dir(
    path: str,
    unet_config: UNetConfig,
    unet_state: Mapping[str, torch.Tensor],
    vae_config: VAEConfig,
    vae_state: Mapping[str, torch.Tensor],
    scheduler_config: sched_ops.SchedulerConfig,
    scheduler_class: str = "DDIMScheduler",
    copy_subfolders: Optional[Dict[str, str]] = None,
    image_encoder_config: Optional[clip_models.CLIPVisionConfig] = None,
    image_encoder_state: Optional[Mapping[str, torch.Tensor]] = None,
) -> None:
    """Write an HF-layout pipeline directory: model_index.json, unet/ and vae/
    (config.json + fp32 `diffusion_pytorch_model.bin`), scheduler/, with an
    image encoder an `image_encoder/` (config.json + fp32 `pytorch_model.bin`;
    a GeoWizard pipeline), and each of `copy_subfolders` (name -> source
    directory) copied verbatim."""
    os.makedirs(path, exist_ok=True)
    with_encoder = image_encoder_config is not None and image_encoder_state is not None
    geowizard = with_encoder or "image_encoder" in (copy_subfolders or {})
    index = {
        "_class_name": "GeoWizardPipeline" if geowizard else "MarigoldPipeline",
        "unet": ["diffusers", "UNet2DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"],
        "scheduler": ["diffusers", scheduler_class],
    }
    index.update({sub: _MODEL_INDEX_CLASSES[sub] for sub in copy_subfolders or () if sub in _MODEL_INDEX_CLASSES})
    if with_encoder:
        index["image_encoder"] = _MODEL_INDEX_CLASSES["image_encoder"]
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2)
    for sub, cfg, state in (
        ("unet", unet_config_to_hf(unet_config), unet_state),
        ("vae", vae_config_to_hf(vae_config), vae_state),
    ):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
        with open(os.path.join(path, sub, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        _save_weights(state, os.path.join(path, sub, "diffusion_pytorch_model.bin"))
    if with_encoder:
        os.makedirs(os.path.join(path, "image_encoder"), exist_ok=True)
        with open(os.path.join(path, "image_encoder", "config.json"), "w") as f:
            json.dump(vision_config_to_hf(image_encoder_config), f, indent=2)
        _save_weights(image_encoder_state, os.path.join(path, "image_encoder", "pytorch_model.bin"))
    os.makedirs(os.path.join(path, "scheduler"), exist_ok=True)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(scheduler_config_to_hf(scheduler_config, scheduler_class), f, indent=2)
    for sub, src in (copy_subfolders or {}).items():
        dst = os.path.join(path, sub)
        if os.path.abspath(src) != os.path.abspath(dst):
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(src, dst)


def frozen_tower_subfolders(source_checkpoint: str, modality: str = "depth") -> Dict[str, str]:
    """The frozen towers a final export carries from its base checkpoint:
    depth / normals runs need text_encoder (tokenizer and feature_extractor
    when present), joint (GeoWizard) runs image_encoder (feature_extractor
    when present). Raises if the required tower is missing from the source."""
    if modality == "joint":
        required, optional = "image_encoder", ("feature_extractor",)
    else:
        required, optional = "text_encoder", ("tokenizer", "feature_extractor")
    src = os.path.join(source_checkpoint, required)
    if not os.path.isdir(src):
        raise FileNotFoundError(
            f"base checkpoint {source_checkpoint} has no {required}/ subfolder; the final export for "
            f"modality={modality!r} must include it"
        )
    out = {required: src}
    for sub in optional:
        if os.path.isdir(os.path.join(source_checkpoint, sub)):
            out[sub] = os.path.join(source_checkpoint, sub)
    return out
