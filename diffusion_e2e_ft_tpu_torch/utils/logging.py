"""Scalar logging and the step-time meter of the training loop: small copies of
`diffusion_e2e_ft_tpu/utils/logging.py` (JSONL part) and
`utils/profiling.py::StepTimer`, so the port's loop imports nothing of the
JAX package. In a data-parallel group only rank 0 writes: the others'
`ScalarLogger` and `write_arguments` do nothing."""

from __future__ import annotations

import json
import os
import time
from typing import List, Mapping, Optional

from diffusion_e2e_ft_tpu_torch.parallel.sharding import is_main_process


class ScalarLogger:
    """Append scalars to <dir>/metrics.jsonl, one JSON object per call."""

    def __init__(self, log_dir: str):
        self._jsonl = None
        if is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        if self._jsonl is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def write_arguments(path_dir: str, arguments: Mapping, filename: str = "arguments.txt") -> None:
    """Dump the resolved run configuration, one `key: value` line each."""
    if not is_main_process():
        return
    os.makedirs(path_dir, exist_ok=True)
    with open(os.path.join(path_dir, filename), "w") as f:
        for k in sorted(arguments):
            f.write(f"{k}: {arguments[k]}\n")


class StepTimer:
    """Rolling step-time and items/sec meter (skips the first, warm-up steps)."""

    def __init__(self, skip_first: int = 2, window: int = 50):
        self.skip_first = skip_first
        self.window = window
        self._times: List[float] = []
        self._count = 0
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip_first:
                self._times.append(now - self._last)
                if len(self._times) > self.window:
                    self._times.pop(0)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def items_per_sec(self, items_per_step: int = 1) -> float:
        t = self.mean_step_time
        return items_per_step / t if t and t == t else float("nan")
