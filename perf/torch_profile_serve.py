"""Where the time goes in a bf16 serving request of the PyTorch port, on one GPU.

    python3 perf/torch_profile_serve.py [--model marigold|geowizard|baseline] [--out <per-op tables file>]

A full-width pipeline with seeded random weights runs in bf16 on `cuda:0`:
SD2 Marigold (`UNetConfig.sd2()`, `VAEConfig()`) or GeoWizard
(`UNetConfig.geowizard()`, `VAEConfig()`, the ViT-L/14 image tower; joint
depth + normals, batch 2 in the UNet and the decode). For 768x768 and then
576x768 (the reference's resolution) it prints:

- the first request at that shape (host clock, synchronized), then the
  median of three warm ones;
- the device body's stage split, VAE encode / (GeoWizard: image tower) /
  UNet / VAE decode, from CUDA events around each stage, median of 5;
- over 3 warm `MarigoldPipeline.__call__` requests under
  torch.profiler: host wall time, summed kernel time, the idle share
  1 - kernel time / wall, and kernel time grouped by kind.

`--model baseline` profiles Marigold's multi-step ensemble baseline instead
(480x640 at processing_res 0, 50 trailing-DDIM steps, ensemble 10, pyramid
noise, seed 1234, `find_batch_size`'s batch): the first request and five
warm ones (host clock: median, min, max); two warm requests with their
stages timed in place (the draws, the encode, each UNet call, the decode,
the BFGS: CUDA events and host time around the pipeline's own callables,
and how far the device lags the host at each stage's start); and one
request under the profiler (wall, kernel time, idle share).

The profiler's per-op tables go to `--out`. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip
from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, MarigoldPipeline
from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import domain_one_hot, switcher_embedding

RESOLUTIONS = ((768, 768), (576, 768))  # in order: the second shows the first request at a new shape
# Marigold's multi-step ensemble baseline (experiments/depth/eval_args/marigold_diffusion_baseline/11_infer_nyu.sh)
BASELINE_HW = (480, 640)
BASELINE = dict(denoising_steps=50, ensemble_size=10, noise="pyramid", processing_res=0, batch_size=0, seed=1234)
REQUESTS = 3  # warm requests under the profiler
BASELINE_WARM = 5  # warm baseline requests timed on the host clock

# kernel-name substrings -> kind, first match wins
KINDS = (
    ("flash attention fwd (ours)", ("flash_fwd_kernel",)),
    ("flash attention bwd (ours)", ("flash_bwd_",)),
    ("GroupNorm, GN -> conv (ours)", ("gn_conv", "channel_stats_kernel", "gn_apply", "gn_group")),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions", ("fprop", "conv", "cudnn", "dgrad", "wgrad")),
    ("GEMMs", ("gemm", "cutlass", "cublas", "nvjet")),
    ("memcpy / memset", ("Memcpy", "Memset")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("elementwise and reductions", ("elementwise", "reduce", "copy", "upsample")),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@torch.inference_mode()
def stage_split(pipe, img: np.ndarray, reps: int = 5) -> dict:
    """Median device ms of each stage of the one-step device body."""
    rgb = torch.from_numpy(img.astype(np.float32)).cuda()[None] / 127.5 - 1.0
    geowizard = isinstance(pipe, GeoWizardPipeline)
    names = ("encode", "image tower", "UNet", "decode") if geowizard else ("encode", "UNet", "decode")
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        x = rgb.to(pipe.dtype).permute(0, 3, 1, 2)
        ev[0].record()
        lat = pipe.vae.encode_mean(x) * pipe.latent_scale_factor
        ev[1].record()
        if geowizard:  # the task pair: batch 2 through the UNet and the decode
            embed = pipe.image_encoder(clip.clip_preprocess((rgb + 1.0) / 2.0))[:, None].to(pipe.dtype)
            ev[2].record()
            lat, context = torch.cat([lat, lat]), torch.cat([embed, embed])
            labels = switcher_embedding(domain_one_hot("indoor")).cuda()
            out = pipe.unet(torch.cat([lat, torch.zeros_like(lat)], dim=1), 999, context, labels)
        else:
            context = pipe.empty_text_embed.expand(1, -1, -1)
            out = pipe.unet(torch.cat([lat, torch.zeros_like(lat)], dim=1), 999, context)
        ev[-2].record()
        pipe.vae.decode(out / pipe.latent_scale_factor)
        ev[-1].record()
        torch.cuda.synchronize()
        times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
    return {name: statistics.median(col) for name, col in zip(names, zip(*times))}


class StageClock:
    """CUDA events and host timestamps around the stages of real requests,
    taken by wrapping the pipeline's own callables (the VAE's encode and
    decode and the UNet as instance attributes, the draws and the BFGS as
    the module attributes the pipeline calls), so the split times the code
    that serves requests, whatever its scheduler."""

    def __init__(self, pipe):
        from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens
        from diffusion_e2e_ft_tpu_torch.ops import noise as noise_ops

        self.targets = [("draws", noise_ops, "member_draws"), ("encode", pipe.vae, "encode_mean"),
                        ("UNet", pipe.unet, "forward"), ("decode", pipe.vae, "decode"),
                        ("BFGS", ens, "align_depths")]
        self.marks = []  # (stage, host start, event start, host end, event end)

    def _wrap(self, stage, fn):
        def call(*args, **kwargs):
            h0, e0 = time.perf_counter(), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self.marks.append((stage, h0, e0, time.perf_counter(), e1))
            return out
        return call

    def run(self, request) -> dict:
        """One request with the stages wrapped: its wall ms and, a stage, the
        calls, device ms (events), host ms, and the device's lag at each
        call's start (event time minus host time since the request began:
        > 0 while the device still works through earlier launches, ~0 when it
        waits for the host)."""
        saved = [(obj, name, obj.__dict__.get(name)) for _, obj, name in self.targets]
        for stage, obj, name in self.targets:
            setattr(obj, name, self._wrap(stage, getattr(obj, name)))
        self.marks = []
        try:
            torch.cuda.synchronize()
            h_start, e_start = time.perf_counter(), torch.cuda.Event(enable_timing=True)
            e_start.record()
            request()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - h_start) * 1e3
        finally:
            for obj, name, old in saved:
                if old is None:
                    delattr(obj, name)
                else:
                    setattr(obj, name, old)
        stages = {}
        for stage, h0, e0, h1, e1 in self.marks:
            row = stages.setdefault(stage, {"calls": 0, "device_ms": 0.0, "host_ms": 0.0, "lag_ms": []})
            row["calls"] += 1
            row["device_ms"] += e0.elapsed_time(e1)
            row["host_ms"] += (h1 - h0) * 1e3
            row["lag_ms"].append(e_start.elapsed_time(e0) - (h0 - h_start) * 1e3)
        return {"wall_ms": wall, "stages": stages}


def profile_requests(request, label: str, count: int, tables) -> None:
    """`count` requests under the profiler: wall, kernel time, idle share and kernel time by kind."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            request()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    print(f"[{label}] profiler, {count} requests: wall {wall:.1f} ms, kernel time "
          f"{busy:.1f} ms, idle share {1.0 - busy / wall:.3f}, {len(kernels) / count:.0f} kernels a request", flush=True)
    by_kind: dict = {}
    for e in kernels:
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + e.device_time / 1e3
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {kind:28s} {ms / count:8.2f} ms per request", flush=True)
    tables.write(f"== {label}, {count} requests\n")
    tables.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40,
                                           max_name_column_width=90))
    tables.write("\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("marigold", "geowizard", "baseline"), default="marigold")
    ap.add_argument("--out", default="chiprun_out/torch_profile.txt", help="per-op tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_serve: needs a CUDA device")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.model == "geowizard":
        pipe = GeoWizardPipeline.from_random(UNetConfig.geowizard(), VAEConfig(), clip.CLIPVisionConfig(), seed=0,
                                             device="cuda", dtype=torch.bfloat16)
    else:
        pipe = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=0, device="cuda",
                                            dtype=torch.bfloat16)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as tables:
        if args.model == "baseline":
            img = np.random.default_rng(0).integers(0, 256, (*BASELINE_HW, 3), dtype=np.uint8)

            def request():
                return pipe(img, color_map=None, **BASELINE)

            first = synced_ms(request)
            warm = [synced_ms(request) for _ in range(BASELINE_WARM)]
            print(f"[baseline] first request {first:.1f} ms; {len(warm)} warm {[round(t, 1) for t in warm]}: median "
                  f"{statistics.median(warm):.1f}, min {min(warm):.1f}, max {max(warm):.1f} ms", flush=True)
            for i in range(2):
                split = StageClock(pipe).run(request)
                print(f"[baseline] warm request {i + 1} with its stages timed: wall {split['wall_ms']:.1f} ms",
                      flush=True)
                for stage, row in split["stages"].items():
                    lag = row["lag_ms"]
                    print(f"[baseline]   {stage:6s} x {row['calls']:2d}: device {row['device_ms']:8.1f} ms, host "
                          f"{row['host_ms']:8.1f} ms; device lag at each start, ms: median "
                          f"{statistics.median(lag):.1f}, min {min(lag):.1f}, max {max(lag):.1f}", flush=True)
            profile_requests(request, "baseline", 1, tables)
        for hw in RESOLUTIONS if args.model != "baseline" else ():
            res = f"{hw[0]}x{hw[1]}"
            img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)

            def request():
                return pipe(img, processing_res=max(hw), color_map=None)

            first = synced_ms(request)
            warm = statistics.median(synced_ms(request) for _ in range(3))
            print(f"[{res}] first request {first:.2f} ms, warm median of 3 {warm:.2f} ms", flush=True)
            stages = stage_split(pipe, img)
            print(f"[{res}] device body, CUDA events, median of 5: "
                  + ", ".join(f"{name} {ms:.2f} ms" for name, ms in stages.items()), flush=True)
            profile_requests(request, res, REQUESTS, tables)
    print(f"per-op tables: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
