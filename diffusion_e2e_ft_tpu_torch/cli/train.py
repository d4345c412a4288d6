"""E2E fine-tuning CLI, port of `diffusion_e2e_ft_tpu/cli/train.py`: the depth
and normals trainer, and with `--modality joint` the GeoWizard trainer.

Flow: load a base HF checkpoint -> conv_in 4 -> 8 surgery when starting from
raw SD2 with a noise type -> Hypersim + VirtualKITTI2 mixed 9:1 (the port's
copies of the JAX package's numpy `data/` readers) -> the train step,
data-parallel over `--num_devices` ranks -> periodic checkpoints -> final HF
export with trailing scheduler spacing and the frozen tower copied in: the
text tower, or for joint runs the image tower (`image_encoder/`, +
`feature_extractor/`).

Data parallelism: `--num_devices N` (default: every visible device of
`--device`'s kind, the one CPU for `--device cpu`) trains N ranks, one
process and device each, on a global batch of `--train_batch_size` x N rows;
the LR schedule's lengths scale by N, as in the JAX CLI. With N > 1 the CLI
starts the N processes itself (NCCL between cards, gloo between CPU ranks,
a `file://` rendezvous under `--output_dir`), or, started by `torchrun`, it
joins that group (`env://`). Each rank reads only its rows of each batch;
rank 0 logs, checkpoints and exports. More ranks than visible cards raise.

A joint run builds its UNet with joint (cross-task) attention when it has a
class embedding, as `loading.load_geowizard_pipeline` serves it: GeoWizard
trains with that attention. (The JAX CLI loads the UNet without it.)

    python -m diffusion_e2e_ft_tpu_torch.cli.train --pretrained_model_name_or_path <dir> \\
        --hypersim_root data/hypersim --vkitti_root data/virtual_kitti_2 --half_precision

The trainer runs `TrainConfig`'s defaults beyond the flags below, as the JAX
CLI does: the frozen VAE's resnet pairs go through the fused
GroupNorm+SiLU->conv kernels on the card (`fused_vae_kernels=True`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time

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
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel degree (default: every visible device of --device's kind)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--half_precision", action="store_true", help="compute in bfloat16 (fp32 master weights)")
    return p


def data_parallel_world(args) -> int:
    """The number of ranks `args` asks for: `--num_devices`, by default every
    visible device of `--device`'s kind. Raises past the visible cards (CPU
    ranks share the host, up to one a core)."""
    from diffusion_e2e_ft_tpu_torch.parallel.mesh import visible_devices

    kind = torch.device(args.device).type
    visible = len(visible_devices(kind)) if kind == "cuda" else os.cpu_count() or 1
    if visible == 0:
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible")
    n = args.num_devices
    if n is None:
        n = len(visible_devices(kind))
    if n < 1 or n > visible:
        raise ValueError(f"--num_devices {n}: {visible} {kind} device(s) can take a rank here")
    return n


def _torchrun_rank():
    """(rank, world, local rank) when torchrun started this process, else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", 0))
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    joined = _torchrun_rank()
    if joined is not None:
        rank, world, local = joined
        if args.num_devices not in (None, world):
            raise ValueError(f"--num_devices {args.num_devices} in a torchrun group of {world}")
        return train(args, rank, world, local, init_file=None)
    world = data_parallel_world(args)
    if world == 1:
        return train(args)
    os.makedirs(args.output_dir, exist_ok=True)
    init_file = os.path.join(os.path.abspath(args.output_dir), f".rendezvous-{os.getpid()}-{time.time_ns()}")
    try:
        torch.multiprocessing.spawn(_rank_main, args=(args, world, init_file), nprocs=world, join=True)
    finally:
        if os.path.exists(init_file):
            os.remove(init_file)


def _rank_main(rank: int, args, world: int, init_file: str) -> None:
    if torch.device(args.device).type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    train(args, rank, world, rank, init_file)


def train(args, rank: int = 0, world: int = 1, local_rank: int = 0, init_file=None):
    """Train as `rank` of `world` (one process, no group, when world is 1 and
    no group is being joined)."""
    from diffusion_e2e_ft_tpu_torch.data.mixer import BatchLoader, MixedLoader, Prefetcher
    from diffusion_e2e_ft_tpu_torch.data.train_datasets import Hypersim, VirtualKITTI2
    from diffusion_e2e_ft_tpu_torch.models import UNet2DCondition, convert
    from diffusion_e2e_ft_tpu_torch.parallel.sharding import init_data_parallel
    from diffusion_e2e_ft_tpu_torch.pipelines import loading
    from diffusion_e2e_ft_tpu_torch.training import checkpoints as ckpt
    from diffusion_e2e_ft_tpu_torch.training.config import TrainConfig
    from diffusion_e2e_ft_tpu_torch.training.geowizard import GeoWizardTrainer
    from diffusion_e2e_ft_tpu_torch.training.loop import run_training
    from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer, gather_tensors

    dp, device = None, torch.device(args.device)
    if world > 1 or init_file is None and _torchrun_rank() is not None:
        if device.type == "cuda":
            device = torch.device("cuda", local_rank)
        dp = init_data_parallel(rank, world, device, init_file=init_file)
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
        num_data_parallel=world,
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

    global_batch = args.train_batch_size * world

    def make_epoch_iter(epoch: int):  # this rank's rows of the global batches
        l1 = BatchLoader(hyper, global_batch, args.modality, seed=args.seed + epoch, rank=rank, world=world)
        l2 = BatchLoader(vkitti, global_batch, args.modality, seed=args.seed + epoch, rank=rank, world=world)
        return Prefetcher(MixedLoader(l1, l2, 9, 1, seed=args.seed + epoch))

    # --- trainer ----------------------------------------------------------
    compute_dtype = torch.bfloat16 if args.half_precision else None
    if args.modality == "joint":
        encoder = loading.load_image_encoder(os.path.join(path, "image_encoder"))
        trainer = GeoWizardTrainer(config, unet.to(device), vae, encoder, sched_cfg, compute_dtype=compute_dtype)
    else:
        empty = loading.compute_empty_text_embed(os.path.join(path, "text_encoder"), device=device, pad_to=77)
        trainer = E2ETrainer(config, unet.to(device), vae, empty, sched_cfg, compute_dtype=compute_dtype)
    if dp is not None:
        trainer.place_frozen(dp)
    state = run_training(trainer, trainer.init_state(), make_epoch_iter, resume_from=args.resume_from_checkpoint)

    # --- final export (trailing spacing baked in, the frozen tower copied in), rank 0
    # the exported tree's full tensors, on the host, of a sharded state (a collective), else the tree itself
    final = gather_tensors(state.ema_params if state.ema_params is not None else state.params, state.sharding, "cpu")
    export_dir = os.path.join(args.output_dir, "export")
    ckpt.export_hf_pipeline(
        export_dir, unet.config, final, vae.config, vae.state_dict(), sched_cfg, source_checkpoint=path,
        modality=args.modality,
    )
    if dp is not None:
        dp.barrier()  # the export is on disk before any rank returns
        dp.close()
    if rank == 0:
        print(f"[train] exported HF pipeline to {export_dir}", flush=True)


if __name__ == "__main__":
    main()
