"""Folder-of-images depth/normal inference CLI.

Port of `diffusion_e2e_ft_tpu/cli/run_marigold.py` (Marigold's `run.py`):
walks an image folder, runs the Marigold pipeline on `--device` (default
cuda), saves `depth_npy/*.npy`, `depth_colored/*.png` and 16-bit
`depth_bw/*.png` (or `normal_npy` / `normal_colored` with `--normals`).
`--profile_dir` writes a `torch.profiler` trace of the run there
(`trace.json`, Chrome trace format) and the port's own spans of the run
(`spans.jsonl`, one span a line: name, span, parent and request ids, start
and end in `time.time_ns()` nanoseconds, counters; `utils/trace.py`).

    python -m diffusion_e2e_ft_tpu_torch.cli.run_marigold --checkpoint <dir> \\
        --input_rgb_dir <dir> --output_dir <dir> --half_precision
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.cli.common import (
    add_device_argument,
    list_images,
    load_image_rgb,
    make_parser,
    resolve_device,
    save_image,
)
from diffusion_e2e_ft_tpu_torch.ops import image as im
from diffusion_e2e_ft_tpu_torch.utils import trace
from diffusion_e2e_ft_tpu_torch.utils.logging import write_arguments
from diffusion_e2e_ft_tpu_torch.utils.seeding import seed_all


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--checkpoint", required=True, help="HF pipeline directory")
    p.add_argument("--input_rgb_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--normals", action="store_true", help="predict surface normals")
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--timestep_spacing", choices=["trailing", "leading", "linspace"], default=None)
    p.add_argument("--noise", choices=["gaussian", "pyramid", "zeros"], default="zeros")
    p.add_argument("--processing_res", type=int, default=768)
    p.add_argument("--output_processing_res", action="store_true")
    p.add_argument("--half_precision", action="store_true", help="run in bfloat16")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--resample_method", choices=["bilinear", "bicubic", "nearest"], default="bilinear")
    p.add_argument("--color_map", default="Spectral")
    p.add_argument("--profile_dir", default=None, help="write a torch.profiler trace here")
    add_device_argument(p, "the pipeline")
    return p


@contextlib.contextmanager
def profiled(profile_dir, device):
    """torch.profiler over the block (CUDA activity too on a CUDA device),
    its Chrome trace written to `profile_dir/trace.json` and the spans the
    port recorded meanwhile to `profile_dir/spans.jsonl`; nothing without a
    directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    trace.clear()
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "spans.jsonl"), "w") as f:
        for s in trace.spans():
            f.write(json.dumps(s._asdict()) + "\n")
    print(f"[run] profiler trace written to {profile_dir}", flush=True)


def main(argv=None):
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_all(args.seed if args.seed is not None else 0)

    dtype = torch.bfloat16 if args.half_precision else torch.float32
    pipe = MarigoldPipeline.from_hf_dir(args.checkpoint, device=device, dtype=dtype)
    if args.timestep_spacing is not None:
        pipe.scheduler_config = pipe.scheduler_config.replace(timestep_spacing=args.timestep_spacing)

    write_arguments(args.output_dir, vars(args))
    names = ("normal_npy", "normal_colored") if args.normals else ("depth_npy", "depth_colored", "depth_bw")
    sub = {name: os.path.join(args.output_dir, name) for name in names}
    for d in sub.values():
        os.makedirs(d, exist_ok=True)

    images = list_images(args.input_rgb_dir)
    if not images:
        raise SystemExit(f"no images found in {args.input_rgb_dir}")
    print(f"[run] {len(images)} images", flush=True)

    with profiled(args.profile_dir, device):
        for path in images:
            out = pipe(
                load_image_rgb(path),
                denoising_steps=args.denoise_steps,
                ensemble_size=args.ensemble_size,
                processing_res=args.processing_res,
                match_input_res=not args.output_processing_res,
                resample_method=args.resample_method,
                batch_size=args.batch_size,
                noise=args.noise,
                normals=args.normals,
                seed=args.seed,
                color_map=args.color_map,
            )
            stem = os.path.splitext(os.path.basename(path))[0]
            if args.normals:
                np.save(os.path.join(sub["normal_npy"], f"{stem}_pred.npy"), out.normal_np)
                save_image(os.path.join(sub["normal_colored"], f"{stem}_colored.png"), out.normal_colored)
            else:
                np.save(os.path.join(sub["depth_npy"], f"{stem}_pred.npy"), out.depth_np)
                save_image(os.path.join(sub["depth_colored"], f"{stem}_colored.png"), out.depth_colored)
                save_image(os.path.join(sub["depth_bw"], f"{stem}_bw.png"), im.to_uint16(out.depth_np))
            print(f"[run] {stem} done", flush=True)


if __name__ == "__main__":
    main()
