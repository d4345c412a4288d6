"""Where the time goes in a bf16 E2E train step of the PyTorch port, on one GPU.

    python3 perf/torch_profile_train.py [--model sd2|geowizard] [--unfused] [--tree DIR] [--split-only]
        [--out output/torch_profile_train.txt]

A full-width SD2 UNet and VAE (`UNetConfig.sd2()`, `VAEConfig()`) with seeded
random weights train at 480x640, batch 2, as `chip_smoke.py`'s training phase
does: fp32 master weights, bf16 compute under autocast, UNet checkpointing,
the default `fused_vae_kernels=True` (`--unfused`: False), K=1, synthetic
batches. `--model geowizard` trains GeoWizard's joint step instead
(`GeoWizardTrainer`, E2E, zeros noise: the SD1.5-shaped UNet with the class
embedding and joint attention at 2B = 4, the SD VAE decoding 4 images, the
CLIP ViT-L/14 image tower), as `chip_smoke.py`'s GeoWizard training phase
does. After two warm-up steps it prints:

- the step's split, forward (encode + UNet + decode + loss) / backward /
  optimizer, from CUDA events around each, and the step on the host clock,
  medians of 5;
- over 3 steps under torch.profiler: host wall time, summed kernel time, the
  idle share 1 - kernel time / wall, CUDA kernels launched a step, kernel
  time grouped by kind (and the GroupNorm statistics and apply apart from
  the fused GN -> conv), and the peak device memory of those steps.

`--split-only` stops after the split (no profiler: a cheaper host-clock
A/B). `E2EFT_GNCONV_IMPL=v2` in the environment runs the single-launch GN ->
conv kernel. `--tree DIR` imports the package from another checkout (a `git archive` of
the parent), for A/Bs in one chip call. The profiler's per-op tables go to
`--out`. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

STEPS = 3  # steps under the profiler


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=["sd2", "geowizard"], default="sd2")
    ap.add_argument("--unfused", action="store_true", help="fused_vae_kernels=False")
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose diffusion_e2e_ft_tpu_torch to import")
    ap.add_argument("--split-only", action="store_true", help="stop after the CUDA-event split")
    ap.add_argument("--out", default="output/torch_profile_train.txt", help="per-op tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_train: needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # torch_profile_serve, beside this file
    sys.path.insert(0, os.path.abspath(args.tree))
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.models.clip import CLIPVisionConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, MarigoldPipeline
    from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, GeoWizardTrainer, TrainConfig
    from torch_profile_serve import kind_of

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; tree {os.path.abspath(args.tree)}; "
          f"model {args.model}; E2EFT_GNCONV_IMPL={os.environ.get('E2EFT_GNCONV_IMPL', 'v1')}", flush=True)
    tag = f"[train {args.model} 480x640 bs 2]"
    config = TrainConfig(fused_vae_kernels=not args.unfused, gradient_checkpointing=True,
                         gradient_accumulation_steps=1, lr_warmup_steps=0)
    rng = np.random.default_rng(3)
    batch = {"rgb": rng.uniform(-1, 1, (2, 480, 640, 3)).astype(np.float32),
             "val_mask": np.ones((2, 480, 640), bool)}
    if args.model == "geowizard":
        models = GeoWizardPipeline.from_random(UNetConfig.geowizard(), VAEConfig(), CLIPVisionConfig(), seed=1,
                                               device="cuda")
        trainer = GeoWizardTrainer(config, models.unet, models.vae, models.image_encoder,
                                   compute_dtype=torch.bfloat16)
        normals = rng.normal(size=(2, 480, 640, 3)).astype(np.float32)
        batch.update(depth_target=rng.uniform(-1, 1, (2, 480, 640)).astype(np.float32),
                     normal_target=normals / np.linalg.norm(normals, axis=-1, keepdims=True),
                     domain=np.array([1.0, 0.0, 0.0], np.float32))
    else:
        models = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=1, device="cuda")
        empty = np.random.default_rng(1).normal(size=(1, 77, 1024)).astype(np.float32)
        trainer = E2ETrainer(config, models.unet, models.vae, empty, compute_dtype=torch.bfloat16)
        batch["target"] = rng.uniform(-1, 1, (2, 480, 640)).astype(np.float32)
    del models
    state = trainer.init_state()
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)

    names, params = zip(*trainer.unet.named_parameters())
    split = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        loss, _ = trainer.loss(batch)
        ev[1].record()
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        ev[2].record()
        trainer.optimizer.update(grads, state.opt_state, state.params)
        ev[3].record()
        torch.cuda.synchronize()
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)] + [(time.perf_counter() - t0) * 1e3])
        del loss, grads
    fwd, bwd, opt, host = (statistics.median(col) for col in zip(*split))
    print(f"{tag} step split, CUDA events, median of 5: forward {fwd:.2f} ms, "
          f"backward {bwd:.2f} ms, optimizer {opt:.2f} ms; host clock {host:.2f} ms a step", flush=True)
    if args.split_only:
        return 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    print(f"{tag} profiler, {STEPS} steps: wall {wall:.1f} ms, kernel time {busy:.1f} ms, "
          f"idle share {1.0 - busy / wall:.3f}, {len(kernels) / STEPS:.0f} CUDA kernels a step, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    by_kind: dict = {}
    for e in kernels:
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + e.device_time / 1e3
    stats_ms = sum(e.device_time for e in kernels if "channel_stats_kernel" in e.name) / 1e3
    apply_ms = sum(e.device_time for e in kernels if "gn_apply" in e.name) / 1e3
    group_ms = sum(e.device_time for e in kernels if "gn_group" in e.name) / 1e3
    print(f"{tag}   of which GN statistics {stats_ms / STEPS:.2f} ms, GN apply {apply_ms / STEPS:.2f} ms, one-launch "
          f"GN {group_ms / STEPS:.2f} ms per step", flush=True)
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"{tag}   {kind:28s} {ms / STEPS:8.2f} ms per step", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as tables:
        tables.write(f"== {tag} fused_vae_kernels={config.fused_vae_kernels}, {STEPS} steps\n")
        tables.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=50,
                                               max_name_column_width=90))
    print(f"per-op tables: {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
