"""Learning-rate schedule, port of `diffusion_e2e_ft_tpu/training/lr.py`:
linear warmup, then iteration-wise exponential decay to a final ratio
(Marigold's `IterExponential`), as a plain function of the optimizer step.
With warmup, lr(0) = 0: the first optimizer step does not move the weights."""

from __future__ import annotations

import math
from typing import Callable


def iter_exponential_schedule(
    base_lr: float,
    total_iter_length: int,
    final_ratio: float = 0.01,
    warmup_steps: int = 100,
) -> Callable[[int], float]:
    """Recomputed per step (no error accumulation): warmup ramps 0 -> 1, then
    alpha = exp(progress * ln(final_ratio)), clamped at final_ratio."""
    effective = max(total_iter_length - warmup_steps, 1)
    log_final = math.log(final_ratio)

    def schedule(step: int) -> float:
        if step >= total_iter_length:
            alpha = final_ratio
        elif step < warmup_steps:
            alpha = step / max(warmup_steps, 1)
        else:
            alpha = math.exp((step - warmup_steps) / effective * log_final)
        return base_lr * alpha

    return schedule
