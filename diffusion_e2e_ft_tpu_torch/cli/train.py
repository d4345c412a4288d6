"""E2E fine-tuning CLI, port of `diffusion_e2e_ft_tpu/cli/train.py`: the depth
and normals trainer, and with `--modality joint` the GeoWizard trainer.

Flow: load a base HF checkpoint -> conv_in 4 -> 8 surgery when starting from
raw SD2 with a noise type -> Hypersim + VirtualKITTI2 mixed 9:1 (the port's
copies of the JAX package's numpy `data/` readers) -> the train step on one device ->
periodic checkpoints -> final HF export with trailing scheduler spacing and
the frozen tower copied in: the text tower, or for joint runs the image tower
(`image_encoder/`, + `feature_extractor/`).

A joint run builds its UNet with joint (cross-task) attention when it has a
class embedding, as `loading.load_geowizard_pipeline` serves it: GeoWizard
trains with that attention. (The JAX CLI loads the UNet without it.)

    python -m diffusion_e2e_ft_tpu_torch.cli.train --pretrained_model_name_or_path <dir> \\
        --hypersim_root data/hypersim --vkitti_root data/virtual_kitti_2 --half_precision

The trainer runs `TrainConfig`'s defaults beyond the flags below, as the JAX
CLI does: the frozen VAE's resnet pairs go through the fused
GroupNorm+SiLU->conv kernels on the card (`fused_vae_kernels=True`).
Data-parallel training (`--num_devices` > 1) is slice F.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, fromfile_prefix_chars="@",
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrained_model_name_or_path", required=True, help="HF pipeline dir")
    p.add_argument("--modality", choices=["depth", "normals", "joint"], default="depth")
    p.add_argument("--noise_type", choices=["zeros", "pyramid", "gaussian", "none"], default="zeros")
    p.add_argument("--output_dir", default="model-finetuned")
    p.add_argument("--hypersim_root", default="data/hypersim")
    p.add_argument("--hypersim_split_csv", default=None)
    p.add_argument("--vkitti_root", default="data/virtual_kitti_2")
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--gradient_accumulation_steps", type=int, default=16)
    p.add_argument("--max_train_steps", type=int, default=20000)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--lr_total_iter_length", type=int, default=20000)
    p.add_argument("--checkpointing_steps", type=int, default=20000)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default=None, help="path or 'latest'")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--no_e2e", action="store_true", help="standard diffusion loss (GeoWizard)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_devices", type=int, default=1, help="data-parallel degree")
    p.add_argument("--device", default="cuda")
    p.add_argument("--half_precision", action="store_true", help="compute in bfloat16 (fp32 master weights)")
    return p


def main(argv=None):
    from diffusion_e2e_ft_tpu_torch.data.mixer import BatchLoader, MixedLoader, Prefetcher
    from diffusion_e2e_ft_tpu_torch.data.train_datasets import Hypersim, VirtualKITTI2
    from diffusion_e2e_ft_tpu_torch.models import UNet2DCondition, convert
    from diffusion_e2e_ft_tpu_torch.pipelines import loading
    from diffusion_e2e_ft_tpu_torch.training import checkpoints as ckpt
    from diffusion_e2e_ft_tpu_torch.training.config import TrainConfig
    from diffusion_e2e_ft_tpu_torch.training.geowizard import GeoWizardTrainer
    from diffusion_e2e_ft_tpu_torch.training.loop import run_training
    from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer

    args = build_parser().parse_args(argv)
    if args.num_devices != 1:
        raise NotImplementedError("data-parallel training (--num_devices > 1) is not ported yet (slice F)")
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    noise_type = None if args.noise_type == "none" else args.noise_type
    config = TrainConfig(
        modality=args.modality,
        noise_type=noise_type,
        learning_rate=args.learning_rate,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_total_iter_length=args.lr_total_iter_length,
        max_train_steps=args.max_train_steps,
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        gradient_checkpointing=args.gradient_checkpointing,
        use_ema=args.use_ema,
        e2e=not args.no_e2e,
        seed=args.seed,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        output_dir=args.output_dir,
    )

    # --- models -----------------------------------------------------------
    path = args.pretrained_model_name_or_path
    unet = loading.load_unet(os.path.join(path, "unet"))
    vae = loading.load_vae(os.path.join(path, "vae"))
    sched_cfg = loading.scheduler_config_from_hf(
        loading._read_json(os.path.join(path, "scheduler", "scheduler_config.json"))
    )
    ucfg, weights = unet.config, unet.state_dict()
    if noise_type is not None and ucfg.in_channels == 4:
        # raw SD2 start: duplicate conv_in for the concatenated noisy latent
        ucfg = dataclasses.replace(ucfg, in_channels=8)
        weights = convert.replace_conv_in(weights, repeat=2)
    if args.modality == "joint":  # cross-task attention, a runtime flag and no weights
        ucfg = dataclasses.replace(ucfg, joint_attention=ucfg.class_embed_proj_dim is not None)
    if ucfg != unet.config:
        with torch.device("meta"):
            unet = UNet2DCondition(ucfg)
        unet.load_state_dict(weights, strict=True, assign=True)

    # --- data -------------------------------------------------------------
    hyper = Hypersim(args.hypersim_root, split_csv=args.hypersim_split_csv, seed=args.seed)
    vkitti = VirtualKITTI2(args.vkitti_root, seed=args.seed)

    def make_epoch_iter(epoch: int):
        l1 = BatchLoader(hyper, args.train_batch_size, args.modality, seed=args.seed + epoch)
        l2 = BatchLoader(vkitti, args.train_batch_size, args.modality, seed=args.seed + epoch)
        return Prefetcher(MixedLoader(l1, l2, 9, 1, seed=args.seed + epoch))

    # --- trainer ----------------------------------------------------------
    compute_dtype = torch.bfloat16 if args.half_precision else None
    if args.modality == "joint":
        encoder = loading.load_image_encoder(os.path.join(path, "image_encoder"))
        trainer = GeoWizardTrainer(config, unet.to(args.device), vae, encoder, sched_cfg, compute_dtype=compute_dtype)
    else:
        empty = loading.compute_empty_text_embed(os.path.join(path, "text_encoder"), device=args.device, pad_to=77)
        trainer = E2ETrainer(config, unet.to(args.device), vae, empty, sched_cfg, compute_dtype=compute_dtype)
    state = run_training(trainer, trainer.init_state(), make_epoch_iter, resume_from=args.resume_from_checkpoint)

    # --- final export (trailing spacing baked in, the frozen tower copied in)
    final = state.ema_params if state.ema_params is not None else state.params
    export_dir = os.path.join(args.output_dir, "export")
    ckpt.export_hf_pipeline(
        export_dir, unet.config, final, vae.config, vae.state_dict(), sched_cfg, source_checkpoint=path,
        modality=args.modality,
    )
    print(f"[train] exported HF pipeline to {export_dir}", flush=True)


if __name__ == "__main__":
    main()
