"""Training checkpoints and the final export, port of
`diffusion_e2e_ft_tpu/training/checkpoints.py`.

Step checkpoints are `checkpoint-<step>/train_state.pt` directories holding a
torch-saved TrainState (counters, UNet parameters, optimizer state, EMA),
rotated to `checkpoints_total_limit` and restored in place. The final export
is an HF pipeline directory with trailing timestep spacing baked into the
scheduler config, as the JAX package's `export_hf_pipeline` writes it; an
export from either package loads in both.

In a data-parallel group only rank 0 writes (`save_checkpoint`,
`export_hf_pipeline`); every rank reads on restore. A sharded state (FSDP)
is gathered bucket by bucket to rank 0's host before rank 0 writes it (every
rank takes part in the gather, and no rank holds more than its shards and
one bucket on the card), so the file is the one a single process writes,
full tensors in the same layout; a sharded state
restores the rank's blocks of the file's tensors, and a single process the
whole file.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from diffusion_e2e_ft_tpu_torch.parallel.sharding import is_main_process
from diffusion_e2e_ft_tpu_torch.parallel.sharding import shard_of
from diffusion_e2e_ft_tpu_torch.training.trainer import TrainState, gather_state

_STEP_RE = re.compile(r"checkpoint-(\d+)$")
STATE_FILE = "train_state.pt"


def _ckpt_path(output_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")


def list_checkpoints(output_dir: str) -> List[Tuple[int, str]]:
    """[(step, path)] sorted ascending."""
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(os.path.abspath(output_dir), name)))
    return sorted(out)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1][1] if ckpts else None


def save_checkpoint(output_dir: str, step: int, state: TrainState, total_limit: Optional[int] = None) -> str:
    """Save the full TrainState; rotate old checkpoints beyond total_limit.
    Returns the checkpoint's path (written by rank 0 only; every rank of a
    sharded state calls it, for the gather, which rank 0 takes to the host
    one bucket at a time and the others drop)."""
    path = _ckpt_path(output_dir, step)
    main = is_main_process()
    state = gather_state(state, "cpu", keep=main)
    if not main:
        return path
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    # not dataclasses.asdict, which would deep-copy every tensor
    torch.save({f.name: getattr(state, f.name) for f in dataclasses.fields(state) if f.name != "sharding"},
               os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)  # a reader never sees a half-written checkpoint
    if total_limit is not None:
        ckpts = list_checkpoints(output_dir)
        for _, old in ckpts[: max(len(ckpts) - total_limit, 0)]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def _copy_into(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        raise ValueError(f"checkpoint {what} do not match the state's: {sorted(set(dst) ^ set(src))[:5]}")
    with torch.no_grad():
        for name, t in dst.items():
            t.copy_(src[name])


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint written by `save_checkpoint` into `state`'s tensors (in
    place, so the UNet module holding them takes the saved weights); a
    sharded state takes the rank's block of each tensor it shards."""
    saved = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu", weights_only=True,
                       mmap=True)
    sh = state.sharding

    def mine(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if sh is None:
            return dict(tree)
        g = sh.group
        return {n: shard_of(t, sh.axes[n], g.fsdp_index, g.fsdp_size) if n in sh.axes else t for n, t in tree.items()}

    _copy_into(state.params, mine(saved["params"]), "params")
    opt: Dict = dict(saved["opt_state"])
    for key, value in state.opt_state.items():
        if isinstance(value, dict):
            _copy_into(value, mine(opt[key]), f"optimizer {key}")
            opt[key] = value
    if (state.ema_params is None) != (saved["ema_params"] is None):
        raise ValueError("checkpoint and state disagree on use_ema")
    if state.ema_params is not None:
        _copy_into(state.ema_params, mine(saved["ema_params"]), "ema params")
    return dataclasses.replace(state, step=saved["step"], micro_step=saved["micro_step"], opt_state=opt)


def step_from_path(path: str) -> int:
    m = _STEP_RE.search(os.path.basename(os.path.normpath(path)))
    if not m:
        raise ValueError(f"not a checkpoint path: {path}")
    return int(m.group(1))


def export_hf_pipeline(
    output_dir: str,
    unet_config,
    unet_state: Mapping[str, torch.Tensor],
    vae_config,
    vae_state: Mapping[str, torch.Tensor],
    scheduler_config,
    scheduler_class: str = "DDPMScheduler",
    source_checkpoint: Optional[str] = None,
    modality: str = "depth",
) -> None:
    """Final export in the HF pipeline layout with TRAILING spacing baked in.
    With `source_checkpoint`, the frozen towers are copied in, so the export
    is self-contained: the text tower (+ tokenizer) for depth / normals runs,
    the image tower (+ feature extractor) for joint runs; the trained UNet
    expects the real empty-prompt or image embedding. `unet_state` holds full
    tensors: a sharded run passes those of `trainer.gather_tensors`."""
    from diffusion_e2e_ft_tpu_torch.pipelines import loading

    if not is_main_process():
        return
    copy_subfolders = None
    if source_checkpoint is not None:
        copy_subfolders = loading.frozen_tower_subfolders(source_checkpoint, modality)
    loading.save_pipeline_dir(
        output_dir, unet_config, unet_state, vae_config, vae_state,
        dataclasses.replace(scheduler_config, timestep_spacing="trailing"),
        scheduler_class=scheduler_class, copy_subfolders=copy_subfolders,
    )
