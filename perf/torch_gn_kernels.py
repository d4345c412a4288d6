"""The GroupNorm kernels of the PyTorch port at the train step's shapes, on one GPU.

    python3 perf/torch_gn_kernels.py [--tree DIR] [--out output/torch_gn_kernels.json]

At each of the 8 GroupNorm -> conv shapes of the 480x640 bs-2 train step's
frozen SD2 VAE (bf16, seeded random values), times: the statistics kernel
(`groupnorm.channel_stats`), the v1 pair as the trainer runs it
(`gn_conv.gn_conv_kernel`: statistics, the weight's layout, the conv), v2
(the same call under `E2EFT_GNCONV_IMPL=v2`: the weight's layout and the
single cooperative launch) and the three-call library composite
(`F.group_norm` -> `F.silu` -> `F.conv2d`, a yardstick the port never
calls). Each as CUDA events around one call (median of 10; host launch
gaps included), back to back (CUDA events around 20 calls, over 20: the
card's time when it outruns the host) and as device time (torch.profiler,
the call's kernels summed, mean of 10), beside its bound (bytes over 3.35
TB/s, operations over 989 TFLOP/s); the host's cost of one call (50 calls
launched back to back, host clock, no synchronisation between them); then
the sums weighted by each shape's launches a train step, and the CUDA
kernels one v1 pair and one v2 call launch.

`--tree DIR` imports the package from another checkout (a `git archive` of
the parent), so one chip call can time parent and change in turns with the
same script. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

# (B, C, H, W, Cout) -> launches a train step: 20 encoder + 28 decoder pairs
SHAPES = {(2, 128, 480, 640, 128): 9, (2, 256, 480, 640, 128): 1, (2, 128, 240, 320, 256): 1,
          (2, 256, 240, 320, 256): 8, (2, 512, 240, 320, 256): 1, (2, 256, 120, 160, 512): 1,
          (2, 512, 120, 160, 512): 9, (2, 512, 60, 80, 512): 18}
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12  # H100 SXM


def event_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels(fn, reps: int = 1) -> list:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, reps: int = 10) -> float:
    return sum(e.device_time for e in kernels(fn, reps)) / 1e3 / reps


def batch_ms(fn, reps: int = 20) -> float:
    """Card time of one call: CUDA events around `reps` calls launched back to
    back (the host runs ahead of the card when a call's kernels take longer
    than its launch, so no host gap is counted)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds a call when `reps` calls are launched back to back
    (the card runs behind; the queue is drained before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / reps * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose diffusion_e2e_ft_tpu_torch to import")
    ap.add_argument("--out", default="output/torch_gn_kernels.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_kernels: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.tree))
    from diffusion_e2e_ft_tpu_torch.kernels import gn_conv as gc
    from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as gn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}; tree {os.path.abspath(args.tree)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for (b, c, h, w, co), launches in SHAPES.items():
        x = (torch.randn((b, c, h, w), device="cuda", generator=gen) + 0.5).bfloat16()
        gw = torch.randn(c, device="cuda", generator=gen) * 0.2 + 1.0
        gb = torch.randn(c, device="cuda", generator=gen) * 0.5
        weight = (torch.randn((co, c, 3, 3), device="cuda", generator=gen) * (9 * c) ** -0.5).bfloat16()
        bias = torch.randn(co, device="cuda", generator=gen) * 0.1

        def pair():
            return gc.gn_conv_kernel(x, gw, gb, 32, 1e-6, weight, bias, True)

        fns = {
            "stats": lambda: gn.channel_stats(x),
            "v1": pair,
            "v2": pair,  # under E2EFT_GNCONV_IMPL=v2, set around its measurements below
            "library": lambda: F.conv2d(F.silu(F.group_norm(x, 32, gw.bfloat16(), gb.bfloat16(), 1e-6)), weight,
                                        bias.bfloat16(), padding=1),
        }
        flops = 2.0 * b * h * w * c * co * 9
        row = {"shape": [b, c, h, w, co], "launches": launches,
               "stats_bound_ms": x.numel() * 2 / PEAK_HBM_BYTES * 1e3,
               "conv_bound_ms": max(flops / PEAK_BF16_FLOPS, (x.numel() + weight.numel() + b * co * h * w) * 2
                                    / PEAK_HBM_BYTES) * 1e3}
        for name, fn in fns.items():
            os.environ["E2EFT_GNCONV_IMPL"] = "v2" if name == "v2" else "v1"
            row[f"{name}_ms"] = event_ms(fn)
            row[f"{name}_batch_ms"] = batch_ms(fn)
            row[f"{name}_device_ms"] = device_ms(fn)
            row[f"{name}_host_us"] = host_us(fn)
            if name in ("v1", "v2"):
                row[f"{name}_kernels"] = len(kernels(fn))
        os.environ.pop("E2EFT_GNCONV_IMPL")
        conv_dev = row["v1_device_ms"] - row["stats_device_ms"]
        print(f"B,C,H,W={b, c, h, w} -> {co} (x{launches}): events / device ms: stats {row['stats_ms']:.4f} / "
              f"{row['stats_device_ms']:.4f} (bound {row['stats_bound_ms']:.4f}), v1 pair {row['v1_ms']:.4f} / "
              f"{row['v1_device_ms']:.4f} (conv + layout {conv_dev:.4f}: {flops / conv_dev / 1e9:.0f} TFLOP/s, "
              f"bound {row['conv_bound_ms']:.4f}), v2 {row['v2_ms']:.4f} / {row['v2_device_ms']:.4f} "
              f"({row['conv_bound_ms'] / row['v2_device_ms']:.3f} of the bound), library {row['library_ms']:.4f} / "
              f"{row['library_device_ms']:.4f}; back to back: stats {row['stats_batch_ms']:.4f}, v1 pair "
              f"{row['v1_batch_ms']:.4f}, v2 {row['v2_batch_ms']:.4f}, library {row['library_batch_ms']:.4f}; "
              f"kernels a call: v1 pair {row['v1_kernels']}, v2 {row['v2_kernels']}; "
              f"host us a call: stats {row['stats_host_us']:.1f}, v1 pair {row['v1_host_us']:.1f}, v2 "
              f"{row['v2_host_us']:.1f}, library {row['library_host_us']:.1f}", flush=True)
        rows.append(row)
        del x, weight
        torch.cuda.empty_cache()
    sums = {k: sum(r["launches"] * r[k] for r in rows) for k in rows[0] if k.endswith("_ms")}
    print("per train step (48 pairs): " + ", ".join(f"{k} {v:.3f}" for k, v in sums.items()), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "tree": os.path.abspath(args.tree), "rows": rows, "per_step": sums}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
