"""HF (diffusers-layout) pipeline directory loading, port of the Marigold part of
`diffusion_e2e_ft_tpu/pipelines/loading.py`.

Reads `unet/`, `vae/`, `scheduler/` and `text_encoder/` subfolders; weights
load with `load_state_dict(strict=True)`, so a missing or extra key fails.
The empty-prompt text embedding is computed once at load time and the text
tower is dropped afterwards.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict

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
    if cfg.get("class_embed_type") is not None:
        raise NotImplementedError("class-embedding UNets (GeoWizard) are not ported yet (slice B)")
    if not cfg.get("use_linear_projection", False):
        raise NotImplementedError("1x1-conv transformer projections (SD1.5 family) are not ported yet (slice B)")
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
        transformer_depth=depth if isinstance(depth, int) else 1,
        norm_num_groups=cfg.get("norm_num_groups", 32),
        norm_eps=cfg.get("norm_eps", 1e-5),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
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
    )


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


@torch.inference_mode()
def compute_empty_text_embed(text_encoder_dir: str, device="cpu") -> np.ndarray:
    """Run the checkpoint's text tower on the empty prompt once; return [1, L, D] fp32."""
    cfg = text_config_from_hf(_read_json(os.path.join(text_encoder_dir, "config.json")))
    model = _load_module(clip_models.CLIPTextModel, cfg, _find_weights(text_encoder_dir))
    model = model.to(device=device, dtype=torch.float32).eval()
    ids = torch.as_tensor(clip_models.empty_prompt_ids(), device=device)
    return model(ids).cpu().numpy()


def load_marigold_pipeline(
    path: str, device="cpu", dtype: torch.dtype = torch.float32, allow_missing_text_encoder: bool = False
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
