"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
2. build: the CUDA sources under `diffusion_e2e_ft_tpu_torch/csrc/` with nvcc;
3. the flash-attention kernel against its plain PyTorch version on the card,
   fp32 and bf16, at the main path's attention shapes (768x768 and 576x768,
   whose 432-token level is ragged for the kernel's tiles) and ragged ones:
   max |delta| against the plain version in fp32, and both times (CUDA events);
4. end-to-end parity, fp32 with TF32 off: a full-width SD2 Marigold pipeline
   with seeded random weights runs one 256x256 image, depth and normals, on
   the CPU (plain path) and on the GPU (kernel path, 12 kernel launches each);
5. serving, the main path: the same weights written as an HF pipeline
   directory (bf16 `.bin` files), loaded with `MarigoldPipeline.from_hf_dir`
   on the GPU in bf16, and a `PipelineService` answering 768x768 depth,
   768x768 normals and 576x768 depth requests (17 kernel launches each), with
   latency and peak device memory.

The line before the last is one JSON object with the kernels' numbers; the
last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# One card: every phase runs on cuda:0, and the result line counts what the
# process can see. Set before torch touches CUDA.
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np
import torch

FP32_BOUND = 1e-4  # kernel vs plain, fp32: summation order only
BF16_BOUND = 2e-2  # kernel (bf16 in, bf16 P, bf16 out) vs plain in fp32
E2E_BOUNDS = {  # fp32 pipeline output, GPU vs CPU (cuDNN vs CPU conv summation order)
    "depth": 1e-3,
    "normals": 5e-3,  # unit-normalizing amplifies differences where |decoded| is small
}
ATTN_CASES = [  # (B, L, N, D); the kernel's tiles are 64 rows at d=64, 32 (bf16) / 16 (fp32) at d=512
    (1, 9216, 5, 64),  # 768x768: UNet levels 0-2, VAE mid
    (1, 2304, 10, 64),
    (1, 576, 20, 64),
    (1, 9216, 1, 512),
    (1, 6912, 5, 64),  # 576x768: UNet levels 0-2, VAE mid
    (1, 1728, 10, 64),
    (1, 432, 20, 64),  # ragged for the tiles: 6 * 64 + 48
    (1, 6912, 1, 512),
    (2, 4800, 1, 64),  # 480x640 level 0
    (2, 300, 3, 64),  # ragged: 4 * 64 + 44
    (3, 300, 1, 512),  # ragged: 9 * 32 + 12, 18 * 16 + 12
]
SITES_256 = 12  # kernel launches for one 256x256 image
SITES_768 = 17  # kernel launches for one 768x768 or 576x768 image


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, from CUDA events around each call."""
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


def phase_kernels(fa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, serving = 0.0, None
    for dtype, bound in ((torch.float32, FP32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for shape in ATTN_CASES:
            q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
            err = (out.float() - ref).abs().max().item()
            check(bool(torch.isfinite(out).all()), f"kernel output not finite at {shape} {dtype}")
            check(err <= bound, f"kernel vs plain max|d| {err} > {bound} at {shape} {dtype}")
            ms = time_ms(lambda: fa.flash_attention(q, k, v))
            plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v))
            torch.cuda.synchronize()
            print(f"[kernel] {str(dtype):15s} B,L,N,D={shape}: max|d|={err:.3e} (bound {bound}) "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
            worst = max(worst, err)
            if dtype == torch.bfloat16 and shape == ATTN_CASES[0]:
                serving = (ms, plain_ms)
            del q, k, v, out, ref
    return {"max_abs_err": worst, "ms": serving[0], "plain_ms": serving[1]}


def phase_e2e_parity(fa):
    from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    t0 = time.perf_counter()
    cpu = MarigoldPipeline.from_random(UNetConfig.sd2(), VAEConfig(), seed=0, device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (1, 256, 256, 3)).astype(np.float32)
    rgb = torch.from_numpy(img / 255.0 * 2.0 - 1.0)
    # depth is clipped to [-1, 1] before it maps to [0, 1]; the normals are the
    # decoded output unclipped (only normalized), so they see every pixel
    want = {task: cpu.infer(rgb, normals=task == "normals") for task in ("depth", "normals")}
    print(f"[e2e] cpu fp32 runs {time.perf_counter() - t0:.1f} s (incl. random init)", flush=True)
    gpu = MarigoldPipeline(cpu.unet, cpu.vae, cpu.scheduler_config, cpu.empty_text_embed,
                           device="cuda", dtype=torch.float32)
    for task, ref in want.items():
        fa.reset_launches()
        got = gpu.infer(rgb.cuda(), normals=task == "normals")
        torch.cuda.synchronize()
        launches = fa.launches
        err = (got.cpu() - ref).abs().max().item()
        inside = ((ref > 0) & (ref < 1)).float().mean().item()
        bound = E2E_BOUNDS[task]
        print(f"[e2e] fp32 256x256 {task}, gpu vs cpu: max|d|={err:.3e} (bound {bound}), "
              f"kernel launches {launches}, values in (0, 1): {inside:.3f}", flush=True)
        check(launches == SITES_256, f"expected {SITES_256} kernel launches at 256x256, got {launches}")
        check(bool(torch.isfinite(got).all()), f"gpu {task} not finite")
        check(err <= bound, f"fp32 pipeline {task} gpu vs cpu max|d| {err} > {bound}")
    return gpu


def write_checkpoint(path: str, pipe, text_config) -> None:
    """HF pipeline directory of the pipeline's weights in bf16 `.bin` files,
    plus a text encoder with seeded random weights."""
    from diffusion_e2e_ft_tpu_torch.models import clip
    from diffusion_e2e_ft_tpu_torch.pipelines.marigold import init_random_

    u, v, t = pipe.unet.config, pipe.vae.config, text_config
    te = clip.CLIPTextModel(t)
    init_random_(te, torch.Generator().manual_seed(1))
    configs = {
        "unet": {
            "in_channels": u.in_channels, "out_channels": u.out_channels,
            "block_out_channels": list(u.block_out_channels), "layers_per_block": u.layers_per_block,
            "down_block_types": ["CrossAttnDownBlock2D" if a else "DownBlock2D" for a in u.cross_attention_levels],
            "attention_head_dim": list(u.num_attention_heads), "cross_attention_dim": u.cross_attention_dim,
            "norm_num_groups": u.norm_num_groups, "norm_eps": u.norm_eps, "use_linear_projection": True,
            "flip_sin_to_cos": u.flip_sin_to_cos, "freq_shift": u.freq_shift,
        },
        "vae": {
            "in_channels": v.in_channels, "out_channels": v.out_channels, "latent_channels": v.latent_channels,
            "block_out_channels": list(v.block_out_channels), "layers_per_block": v.layers_per_block,
            "norm_num_groups": v.norm_num_groups, "scaling_factor": v.scaling_factor,
        },
        "text_encoder": {
            "vocab_size": t.vocab_size, "hidden_size": t.hidden_size, "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads, "intermediate_size": t.intermediate_size,
            "max_position_embeddings": t.max_position_embeddings, "hidden_act": t.hidden_act,
        },
    }
    for sub, module, fname in (
        ("unet", pipe.unet, "diffusion_pytorch_model.bin"),
        ("vae", pipe.vae, "diffusion_pytorch_model.bin"),
        ("text_encoder", te, "pytorch_model.bin"),
    ):
        os.makedirs(os.path.join(path, sub))
        with open(os.path.join(path, sub, "config.json"), "w") as f:
            json.dump(configs[sub], f)
        torch.save({k: t.to("cpu", torch.bfloat16) for k, t in module.state_dict().items()},
                   os.path.join(path, sub, fname))
    os.makedirs(os.path.join(path, "scheduler"))
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "DDIMScheduler", "prediction_type": "v_prediction",
                   "timestep_spacing": "trailing", "beta_schedule": "scaled_linear"}, f)


def phase_serving(fa, fp32_pipe) -> int:
    from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService
    from diffusion_e2e_ft_tpu_torch.models.clip import CLIPTextConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        write_checkpoint(ckpt, fp32_pipe, CLIPTextConfig())  # SD2's OpenCLIP-H text tower
        del fp32_pipe
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        pipe = MarigoldPipeline.from_hf_dir(ckpt, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        print(f"[serve] wrote checkpoint {t1 - t0:.1f} s, from_hf_dir (bf16, cuda) "
              f"{time.perf_counter() - t1:.1f} s", flush=True)

    service = PipelineService(pipe, processing_res=768, denoise_steps=1)
    t0 = time.perf_counter()
    service.warmup()
    print(f"[serve] warmup {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    requests = [("depth", (768, 768)), ("normals", (768, 768)), ("depth", (576, 768))] * 3
    images = {hw: rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _, hw in requests}
    latencies: dict = {}

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # the main path's run starts here
    for task, hw in requests:
        before = fa.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = service.predict(images[hw], normals=task == "normals")
        torch.cuda.synchronize()
        latencies.setdefault((task, hw), []).append((time.perf_counter() - t0) * 1e3)
        check(fa.launches - before == SITES_768,
              f"{task} {hw}: {fa.launches - before} kernel launches, expected {SITES_768}")
        check(pred.shape == (hw + (3,) if task == "normals" else hw), f"{task} {hw}: shape {pred.shape}")
        check(bool(np.isfinite(pred).all()), f"{task} {hw}: non-finite output")
        if task == "depth":
            check(pred.min() >= 0.0 and pred.max() <= 1.0, f"depth {hw} outside [0, 1]")
        else:
            norms = np.linalg.norm(pred, axis=-1)
            check(bool((norms <= 1.0 + 1e-3).all()), f"normals {hw}: norm above 1")
    launches = fa.launches  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    for (task, hw), ms in latencies.items():
        print(f"[serve] bf16 {task} {hw[0]}x{hw[1]}: latency ms {[round(x, 2) for x in ms]} "
              f"(median {statistics.median(ms):.2f})", flush=True)
    print(f"[serve] peak device memory {peak:.3f} GiB; kernel launches {launches} "
          f"over {len(requests)} requests", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch; this run needs one GPU")
    check(torch.cuda.device_count() == 1, f"expected one visible GPU, got {torch.cuda.device_count()}")
    from diffusion_e2e_ft_tpu_torch.kernels import _build
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    lib, seconds, log = _build.build()
    print(f"[build] {lib.relative_to(_build.PACKAGE_DIR.parent)} from "
          f"{[str(s.relative_to(_build.PACKAGE_DIR.parent)) for s in _build.sources()]} "
          f"in {seconds:.2f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    _build.load_library()

    numbers = phase_kernels(fa)
    launches = phase_serving(fa, phase_e2e_parity(fa))  # no reference kept to the fp32 weights
    check(launches > 0, "the main path launched no flash-attention kernel")

    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "diffusion_e2e_ft_tpu_torch/csrc/flash_attention.cu",
        "replaces": "diffusion_e2e_ft_tpu/kernels/flash_attention.py:114",
        "launches": launches,
        "max_abs_err": numbers["max_abs_err"],
        "ms": numbers["ms"],
        "plain_ms": numbers["plain_ms"],
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
