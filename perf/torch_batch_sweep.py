"""Ensemble batch sweep behind `MarigoldPipeline.find_batch_size`, on one GPU.

    python3 perf/torch_batch_sweep.py [--steps 10] [--reps 2] [--out chiprun_out/batch_sweep.json]

A full-width SD2 Marigold pipeline (seeded random weights) in bf16 on the
card runs `infer` on a square image at each processing resolution with each
batch of members (`SWEEP`: 1 to 16 at 512, 1 to 12 at 768, 1 to 10 at 1024,
1 to 4 at 1536): gaussian
initial latents, `--steps` trailing-DDIM steps, one image encode shared by
the members and one decode of the batch. A cell reports the time a member
(CUDA events around the call, median of `--reps` after a warm-up call,
divided by the batch) and the peak device memory of its calls. Only
`torch.cuda.OutOfMemoryError` counts as out of memory.

Prints one line a cell, the card (`nvidia-smi` name and power limit), and
the table `find_batch_size` takes: for each resolution, the batch with the
least time a member among those whose peak stays under half the card's
memory. The cells go to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

SWEEP = {  # max_res: the batches of members swept
    512: (1, 2, 4, 8, 10, 12, 16),
    768: (1, 2, 4, 8, 10, 12),
    1024: (1, 2, 4, 8, 10),
    1536: (1, 2, 3, 4),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cell(pipe, res: int, batch: int, steps: int, reps: int) -> dict:
    """ms a member and peak GiB of `infer` at one resolution and batch."""
    gen = torch.Generator(device="cuda").manual_seed(res + batch)
    rgb = torch.rand((1, res, res, 3), device="cuda", generator=gen) * 2 - 1
    latent0 = torch.randn((batch, 4, res // 8, res // 8), device="cuda", generator=gen).to(pipe.dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    try:
        for i in range(reps + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = pipe.infer(rgb, steps, latent0=latent0)
            end.record()
            end.synchronize()
            if i:  # the first call is the warm-up
                times.append(start.elapsed_time(end))
    except torch.cuda.OutOfMemoryError:
        return {"res": res, "batch": batch, "oom": True, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (batch, res, res):
        raise RuntimeError(f"res {res} batch {batch}: output {tuple(out.shape)} not finite or misshapen")
    ms = statistics.median(times)
    return {"res": res, "batch": batch, "oom": False, "ms_call": ms, "ms_member": ms / batch,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def table(cells: list, limit_gib: float) -> dict:
    """{res: batch}: the least ms a member among the cells under the memory limit."""
    out = {}
    for res in SWEEP:
        fits = [c for c in cells if c["res"] == res and not c["oom"] and c["peak_gib"] < limit_gib]
        if fits:
            out[res] = min(fits, key=lambda c: c["ms_member"])["batch"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--out", default="chiprun_out/batch_sweep.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_batch_sweep: no CUDA device visible to torch; the sweep measures the card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    card = card_line()
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    pipe = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=0, device="cuda", dtype=torch.bfloat16)
    cells = []
    for res, batches in SWEEP.items():
        for batch in batches:
            c = cell(pipe, res, batch, args.steps, args.reps)
            cells.append(c)
            text = "out of memory" if c["oom"] else f"{c['ms_call']:.1f} ms a call, {c['ms_member']:.2f} ms a member"
            print(f"[sweep] {res}x{res} batch {batch:2d}, {args.steps} steps: {text}, peak {c['peak_gib']:.3f} GiB",
                  flush=True)
    chosen = table(cells, total_gib / 2)
    print(f"[sweep] {card}; {total_gib:.1f} GiB; find_batch_size table (under {total_gib / 2:.1f} GiB): {chosen}",
          flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "total_gib": total_gib, "steps": args.steps, "cells": cells, "table": chosen}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
