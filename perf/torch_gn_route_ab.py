"""Host-clock A/B of the standalone GroupNorms' kernel route against the plain version, on one GPU.

    python3 perf/torch_gn_route_ab.py [--pairs 10] [--baseline-pairs 3] [--train-steps 3]
        [--out chiprun_out/torch_gn_route_ab.json]

Every `GroupNormAct` calls `models.layers.group_norm_silu`, which on the card
is `kernels.groupnorm.group_norm_silu`: the statistics kernel and the apply
kernel, two launches a GroupNorm ("route"). The other arm ("plain") rebinds
that name, in this process only, to `kernels.groupnorm.group_norm_reference`,
the plain PyTorch version (about twenty eager launches a GroupNorm); nothing
in the package reads a switch. The arms run in turns (route, plain, plain,
route, ...), so that drift on the card or the host falls on both:

- Marigold serving, bf16, full-width SD2 (`UNetConfig.sd2()`, `VAEConfig()`,
  seeded random weights): a single-step request (`pipe(image,
  processing_res=...)`) at 768x768 and at 576x768, `--pairs` pairs each
  after a warm-up request of each arm;
- the multi-step baseline: 480x640 at processing_res 0, 50 trailing-DDIM
  steps, ensemble 10, pyramid noise, seed 1234, `find_batch_size`'s batch,
  `--baseline-pairs` pairs;
- the E2E train step, 480x640 bs 2, bf16 compute with fp32 masters, UNet
  checkpointing, the default fused VAE: `--train-steps` steps an arm after a
  warm-up step, arms in turns (route, plain, plain, route), with the peak
  device memory of each arm's steps.

Each request or step is timed on the host clock with the card synchronised
before and after. Printed: each arm's times, medians, the median of the
per-pair differences (plain - route), the route's kernel launches a request
or step; the numbers also go to `--out` as JSON. Then three 768x768
requests of each arm under torch.profiler (`torch_profile_serve.py`'s
table: wall, kernel time, idle share, kernels a request, kernel time by
kind; per-op tables beside `--out`). Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.kernels import groupnorm
from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import layers
from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
from torch_profile_serve import profile_requests  # beside this file

ARMS = {"route": groupnorm.group_norm_silu, "plain": groupnorm.group_norm_reference}
RESOLUTIONS = ((768, 768), (576, 768))
BASELINE_HW = (480, 640)
BASELINE = dict(denoising_steps=50, ensemble_size=10, noise="pyramid", processing_res=0, batch_size=0, seed=1234)


def use(arm: str) -> None:
    layers.group_norm_silu = ARMS[arm]


def synced_ms(fn) -> tuple:
    """(host ms of one call with the card synchronised before and after, the GroupNorm kernels it launched)."""
    groupnorm.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, dict(groupnorm.launches)


def in_turns(label: str, fn, pairs: int) -> dict:
    """`pairs` pairs of calls, the arms in turns (route, plain, then plain, route, ...), after one warm-up call
    of each arm."""
    for arm in ARMS:
        use(arm)
        fn()
    times: dict = {arm: [] for arm in ARMS}
    launches: dict = {}
    for i in range(pairs):
        for arm in (("route", "plain") if i % 2 == 0 else ("plain", "route")):
            use(arm)
            ms, n = synced_ms(fn)
            times[arm].append(ms)
            launches[arm] = n
    use("route")
    diffs = [p - r for p, r in zip(times["plain"], times["route"])]
    row = {"ms": times, "median_ms": {arm: statistics.median(t) for arm, t in times.items()},
           "median_plain_minus_route_ms": statistics.median(diffs), "launches": launches}
    print(f"[{label}] {pairs} pairs in turns, host ms: route {[round(x, 2) for x in times['route']]} (median "
          f"{row['median_ms']['route']:.2f}), plain {[round(x, 2) for x in times['plain']]} (median "
          f"{row['median_ms']['plain']:.2f}); median of plain - route a pair {row['median_plain_minus_route_ms']:.2f} "
          f"ms ({min(diffs):.2f} .. {max(diffs):.2f}); GroupNorm kernel launches a call: route {launches['route']}, "
          f"plain {launches['plain']}", flush=True)
    return row


def train_ab(steps: int) -> dict:
    """The E2E train step, each arm's steps in turns (route, plain, plain, route), with each arm's peak."""
    models = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=1, device="cuda")
    empty = np.random.default_rng(1).normal(size=(1, 77, 1024)).astype(np.float32)
    config = TrainConfig(gradient_checkpointing=True, gradient_accumulation_steps=1, lr_warmup_steps=0)
    trainer = E2ETrainer(config, models.unet, models.vae, empty, compute_dtype=torch.bfloat16)
    del models
    rng = np.random.default_rng(3)
    batch = {"rgb": rng.uniform(-1, 1, (2, 480, 640, 3)).astype(np.float32),
             "val_mask": np.ones((2, 480, 640), bool), "target": rng.uniform(-1, 1, (2, 480, 640)).astype(np.float32)}
    state = trainer.init_state()
    times: dict = {arm: [] for arm in ARMS}
    peaks: dict = {arm: 0.0 for arm in ARMS}
    launches: dict = {}
    for arm in ("route", "plain", "plain", "route"):
        use(arm)
        state, _ = trainer.train_step(state, batch)  # the arm's warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(steps):
            def step():
                nonlocal state
                state, _ = trainer.train_step(state, batch)
            ms, launches[arm] = synced_ms(step)
            times[arm].append(ms)
        peaks[arm] = max(peaks[arm], torch.cuda.max_memory_allocated() / 2**30)
    use("route")
    row = {"ms": times, "median_ms": {arm: statistics.median(t) for arm, t in times.items()}, "peak_gib": peaks,
           "launches": launches}
    print(f"[train 480x640 bs 2] {steps} steps an arm, arms in turns (route, plain, plain, route), host ms: route "
          f"{[round(x, 1) for x in times['route']]} (median {row['median_ms']['route']:.1f}), plain "
          f"{[round(x, 1) for x in times['plain']]} (median {row['median_ms']['plain']:.1f}); peak device memory "
          f"GiB: route {peaks['route']:.3f}, plain {peaks['plain']:.3f}; GroupNorm kernel launches a step: route "
          f"{launches['route']}, plain {launches['plain']}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10, help="serving pairs at each resolution")
    ap.add_argument("--baseline-pairs", type=int, default=3)
    ap.add_argument("--train-steps", type=int, default=3, help="timed steps of each arm's two turns")
    ap.add_argument("--out", default="chiprun_out/torch_gn_route_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_route_ab: needs a CUDA device")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, f"; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out = {"card": card}
    pipe = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    for hw in RESOLUTIONS:
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        out[f"serve_{hw[0]}x{hw[1]}"] = in_turns(f"serve {hw[0]}x{hw[1]}", lambda: pipe(img, processing_res=max(hw),
                                                                                         color_map=None), args.pairs)
    img = rng.integers(0, 256, (*RESOLUTIONS[0], 3), dtype=np.uint8)
    with open(os.path.splitext(args.out)[0] + "_profile.txt", "w") as tables:
        for arm in ARMS:
            use(arm)
            profile_requests(lambda: pipe(img, processing_res=max(RESOLUTIONS[0]), color_map=None),
                             f"{arm} {RESOLUTIONS[0][0]}x{RESOLUTIONS[0][1]}", 3, tables)
    use("route")
    img = rng.integers(0, 256, (*BASELINE_HW, 3), dtype=np.uint8)
    out["baseline_480x640"] = in_turns("baseline 480x640 50 steps ensemble 10",
                                       lambda: pipe(img, color_map=None, **BASELINE), args.baseline_pairs)
    del pipe
    torch.cuda.empty_cache()
    out["train_480x640_bs2"] = train_ab(args.train_steps)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"numbers: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
