"""The training loop, port of `diffusion_e2e_ft_tpu/training/loop.py::run_training`:
epochs over the loader, host-side step accounting, the loss averaged over
each accumulation window, periodic checkpoints with rotation, resume from
`latest`, and an emergency checkpoint plus `FloatingPointError` when the
logged loss or gradient norm is not finite.

Losses stay on the device until a log step reads them, so the loop does not
wait for the device at every micro-step. The loop owns the steps' random
stream: a `torch.Generator` on the trainer's device seeded from `config.seed`
(the JAX loop's `jax.random.key(config.seed)`), passed to every step; as in
the JAX loop, it restarts from the seed on resume.

Data parallelism: with the trainer in a group (`trainer.place_frozen`), every
rank runs this loop over its own rows of each global batch. The generators
are seeded alike on every rank, every rank restores the same checkpoint on
resume and starts from rank 0's state, and only rank 0 writes the arguments,
the logs and the checkpoints (every rank gathers a sharded state for
them). `img_per_sec` counts the global batch.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.parallel.sharding import is_main_process
from diffusion_e2e_ft_tpu_torch.training import checkpoints as ckpt
from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer, TrainState
from diffusion_e2e_ft_tpu_torch.utils.logging import ScalarLogger, StepTimer, write_arguments


def run_training(
    trainer: E2ETrainer,
    state: TrainState,
    make_epoch_iter: Callable[[int], Iterable[Dict[str, np.ndarray]]],
    resume_from: Optional[str] = None,
    log_every: int = 10,
) -> TrainState:
    """Run until config.max_train_steps optimizer steps; returns the final state."""
    config = trainer.config
    out_dir = config.output_dir
    world = 1 if trainer.dp is None else trainer.dp.data_size  # the ranks that read distinct rows
    write_arguments(out_dir, {"config": config.to_json()})
    logger = ScalarLogger(os.path.join(out_dir, "logs"))

    if resume_from is not None:
        path = ckpt.latest_checkpoint(out_dir) if resume_from == "latest" else resume_from
        if path is None:
            print(f"[train] no checkpoint found in {out_dir}, starting fresh", flush=True)
        else:
            state = ckpt.restore_checkpoint(path, state)
            print(f"[train] resumed from {path} at step {state.step}", flush=True)
    state = trainer.replicate_state(state)

    generator = torch.Generator(device=trainer.device).manual_seed(config.seed)
    timer = StepTimer()
    accum = config.gradient_accumulation_steps
    step, micro = state.step, state.micro_step
    window_losses = []  # device scalars; read only when logging

    try:
        epoch = 0
        while step < config.max_train_steps:
            for batch in make_epoch_iter(epoch):
                state, metrics = trainer.train_step(state, batch, generator)
                timer.tick()
                window_losses.append(metrics["loss"])
                micro += 1
                if micro % accum:
                    continue
                step += 1
                if step % log_every == 0:
                    window = float(torch.stack(window_losses).sum()) / accum
                    grad_norm = float(metrics["grad_norm"])
                    # the loss is NaN-guarded, so divergence shows in the raw gradient norm:
                    # save the state and stop, resumably
                    if not (np.isfinite(window) and np.isfinite(grad_norm)):
                        path = ckpt.save_checkpoint(out_dir, step, state, config.checkpoints_total_limit)
                        raise FloatingPointError(
                            f"non-finite loss/grad at step {step} "
                            f"(loss={window}, grad_norm={grad_norm}); state saved to {path}"
                        )
                    logger.log(step, {
                        "train_loss": window,
                        "grad_norm": grad_norm,
                        "step_time_s": timer.mean_step_time,
                        "img_per_sec": timer.items_per_sec(len(batch["rgb"]) * world),
                    })
                window_losses = []
                if step % config.checkpointing_steps == 0:
                    path = ckpt.save_checkpoint(out_dir, step, state, config.checkpoints_total_limit)
                    if is_main_process():
                        print(f"[train] saved {path}", flush=True)
                if step >= config.max_train_steps:
                    break
            epoch += 1
    finally:
        logger.close()
    return state
