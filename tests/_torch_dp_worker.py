"""The data-parallel scenarios of `tests/test_torch_parallel.py` and the
FSDP ones of `tests/test_torch_fsdp.py`, importable by spawned ranks: this
module imports torch, numpy and the port only (no JAX), so a rank starts
fast.

A scenario is a trainer config, a model family and a few global batches of
`ROWS` rows. `run` trains it for its micro-steps, in one process
(`dp=None`, the whole global batch) or as one rank of a group (its data
index's rows of each batch, its shards of the state over an fsdp axis), and
returns what the step reports: each micro-step's loss and grad norm, and the
(gathered) parameters at the end; a rank of an fsdp group also returns what
it stores and checks a checkpoint of its group.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as tclip
from diffusion_e2e_ft_tpu_torch.parallel import init_data_parallel
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, GeoWizardTrainer, TrainConfig, gather_state
from diffusion_e2e_ft_tpu_torch.training import checkpoints as C
from diffusion_e2e_ft_tpu_torch.training.trainer import state_tensors

UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
GEO_UNET = dict(UNET, cross_attention_dim=32)
GEO_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, image_size=224, patch_size=32,
              projection_dim=32)
ROWS, H, W = 4, 48, 64  # the global batch; 2 rows a rank with two ranks

# the common optimizer: clipping active, adam_epsilon 1e-3 (no sign flips from float noise in tiny gradients)
OPT = dict(gradient_checkpointing=False, fused_vae_kernels=False, learning_rate=1e-3, lr_warmup_steps=0,
           lr_total_iter_length=10, max_grad_norm=0.05, adam_epsilon=1e-3, seed=7)
SCENARIOS: Dict[str, dict] = {
    # rank 0's rows mostly valid, rank 1's an eighth: a mean of per-rank means would be wrong
    "unequal": dict(family="sd2", micro=2, cfg=dict(modality="depth", noise_type="zeros",
                                                    gradient_accumulation_steps=1)),
    # a NaN target at a valid pixel of rank 1's rows: the global loss is NaN, so every rank's is 0
    "nan": dict(family="sd2", micro=1, cfg=dict(modality="normals", noise_type="zeros",
                                                gradient_accumulation_steps=1)),
    "pyramid": dict(family="sd2", micro=2, cfg=dict(modality="depth", noise_type="pyramid",
                                                    gradient_accumulation_steps=1)),
    "accum": dict(family="sd2", micro=4, cfg=dict(modality="normals", noise_type="gaussian",
                                                  gradient_accumulation_steps=2, use_ema=True, ema_decay=0.9)),
    "joint": dict(family="geowizard", micro=2, cfg=dict(noise_type="pyramid", gradient_accumulation_steps=1)),
    "joint_diffusion": dict(family="geowizard", micro=2, cfg=dict(e2e=False, noise_type="pyramid",
                                                                  gradient_accumulation_steps=1)),
}
# FSDP over (data 2, fsdp 2); the tiny models' leaves of at least 2^12 elements are sharded, as the JAX
# dryrun_multichip shards them
FSDP_DATA, FSDP_SIZE, FSDP_MIN_SIZE = 2, 2, 1 << 12
FSDP_SCENARIOS: Dict[str, dict] = {
    "fsdp_sd2": dict(family="sd2", micro=4, cfg=dict(modality="depth", noise_type="pyramid",
                                                     gradient_accumulation_steps=2, use_ema=True, ema_decay=0.9)),
    # the class embedding's LR group clipped on its own norm (its linear_1 replicated, linear_2 sharded), at
    # the others' LR of 1e-3 (the bound's scale: at 1e-2 the data-parallel step's other summation order,
    # through the bf16 moment's rounding, moves these weights ~8e-6 with fsdp = 1 too)
    "fsdp_joint": dict(family="geowizard", micro=2, cfg=dict(noise_type="pyramid", gradient_accumulation_steps=1,
                                                             learning_rate=1e-4, class_embedding_lr_mult=10.0,
                                                             adam_mu_dtype="bfloat16")),
}
ALL = {**SCENARIOS, **FSDP_SCENARIOS}


def make_batch(name: str, step: int) -> Dict[str, np.ndarray]:
    """Global batch `step` of scenario `name` (numpy, NHWC)."""
    rng = np.random.default_rng(100 * step + len(name))
    rgb = rng.uniform(-1, 1, (ROWS, H, W, 3)).astype(np.float32)
    # invalid pixels in 8-pixel blocks, so that latent cells stay valid for the diffusion loss:
    # rank 0's rows lose one block each, rank 1's keep one block each (an eighth of the pixels)
    mask = np.ones((ROWS, H, W), bool)
    mask[0, :16, :24] = mask[1, 32:, 40:] = False
    mask[2:] = False
    mask[2, 8:24, 16:40] = mask[3, 16:40, 8:24] = True
    depth = rng.uniform(-1, 1, (ROWS, H, W)).astype(np.float32)
    n = rng.normal(size=(ROWS, H, W, 3)).astype(np.float32)
    normals = n / np.linalg.norm(n, axis=-1, keepdims=True)
    if ALL[name]["family"] == "geowizard":
        return {"rgb": rgb, "depth_target": depth, "normal_target": normals, "val_mask": mask,
                "domain": np.array([0.0, 1.0, 0.0], np.float32)}
    target = depth if ALL[name]["cfg"]["modality"] == "depth" else normals
    if name == "nan":
        target[3, 20, 12] = np.nan
        assert mask[3, 20, 12]
    return {"rgb": rgb, "val_mask": mask, "target": target}


def build(name: str, weights: dict):
    """The scenario's trainer on the CPU, over `weights` (port state dicts)."""
    spec = ALL[name]
    config = TrainConfig(**{**OPT, **spec["cfg"]})
    if spec["family"] == "geowizard":
        unet = UNet2DCondition(UNetConfig.geowizard(**GEO_UNET))
        vae = AutoencoderKL(VAEConfig(**GEO_VAE))
        encoder = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig(**VISION))
        for module, key in ((unet, "geo_unet"), (vae, "geo_vae"), (encoder, "geo_encoder")):
            module.load_state_dict(weights[key], strict=True)
        return GeoWizardTrainer(config, unet, vae, encoder.eval())
    unet = UNet2DCondition(UNetConfig.tiny(**UNET))
    vae = AutoencoderKL(VAEConfig(**VAE))
    unet.load_state_dict(weights["unet"], strict=True)
    vae.load_state_dict(weights["vae"], strict=True)
    return E2ETrainer(config, unet, vae.eval(), weights["empty"])


def run(name: str, weights: dict, dp=None, out_dir: Optional[str] = None) -> dict:
    """Train scenario `name`; with `dp`, as its rank, on the rank's rows (and
    its shards, over an fsdp axis, then the checkpoint round trip under
    `out_dir`)."""
    trainer = build(name, weights)
    state = trainer.init_state()
    generator = torch.Generator().manual_seed(trainer.config.seed)
    losses, norms = [], []
    for step in range(ALL[name]["micro"]):
        batch = make_batch(name, step)
        if dp is not None:
            if step == 0:
                state, batch = trainer.shard(state, batch, dp, min_size=FSDP_MIN_SIZE)
            else:
                batch = dp.shard_batch(batch)
        state, metrics = trainer.train_step(state, batch, generator)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    full = gather_state(state)
    out = {"loss": losses, "grad_norm": norms, "step": state.step,
           "params": {n: p.detach().clone() for n, p in full.params.items()}}
    if state.ema_params is not None:
        out["ema"] = {n: p.clone() for n, p in full.ema_params.items()}
    if dp is not None and dp.fsdp_size > 1:
        out.update(fsdp_checks(name, weights, trainer, state, full, dp, out_dir))
    return out


def fsdp_checks(name: str, weights: dict, trainer, state, full, dp, out_dir: str) -> dict:
    """What a rank of an fsdp group stores ({kind/name: elements}: the
    parameters, each optimizer tensor dict, the EMA), whether the UNet holds
    only its replicated tensors between steps, and a checkpoint: saved by the
    group (rank 0 writes; the gathered state of this run kept beside it),
    then restored into a fresh sharded state and replicated from the first
    data group (`replicate_state`), whose shards must equal the live ones to
    the bit."""
    stored = {f"params/{n}": t.numel() for n, t in state.params.items()}
    for key, value in state.opt_state.items():
        if isinstance(value, dict):
            stored.update({f"{key}/{n}": t.numel() for n, t in value.items()})
    stored.update({f"ema/{n}": t.numel() for n, t in (state.ema_params or {}).items()})
    module = {n: p.numel() for n, p in trainer.unet.named_parameters()}
    path = C.save_checkpoint(os.path.join(out_dir, f"ckpt-{name}"), state.step, state)
    dp.barrier()
    fresh = build(name, weights)
    restored, _ = fresh.shard(fresh.init_state(), make_batch(name, 0), dp, min_size=FSDP_MIN_SIZE)
    restored = fresh.replicate_state(C.restore_checkpoint(path, restored))  # shards over the data axis
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(state_tensors(state), state_tensors(restored)))
    out = {"stored": stored, "module": module, "axes": dict(state.sharding.axes), "checkpoint": path,
           "restored_equal": same and restored.step == state.step and restored.micro_step == state.micro_step}
    if dp.rank == 0:
        out["gathered"] = {"params": full.params, "opt_state": full.opt_state, "ema_params": full.ema_params}
    return out


def rank_main(index: int, world: int, init_file: str, weights_path: str, out_dir: str,
              names: Optional[list] = None, fsdp: int = 1) -> None:
    """A spawned process, one thread: index < world joins the gloo group as
    that rank (of `fsdp` ranks an fsdp group), index == world runs the
    one-process reference; each runs every scenario of `names` (default:
    the data-parallel ones) and saves its results as `<scenario>-<index>.pt`."""
    torch.set_num_threads(1)
    weights = torch.load(weights_path, weights_only=False)
    dp = init_data_parallel(index, world, "cpu", init_file=init_file, fsdp=fsdp) if index < world else None
    try:
        for name in names or SCENARIOS:
            torch.save(run(name, weights, dp, out_dir), os.path.join(out_dir, f"{name}-{index}.pt"))
    finally:
        if dp is not None:
            dp.close()
