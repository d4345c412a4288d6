"""Folder-of-images joint depth+normal inference CLI (GeoWizard).

Port of `diffusion_e2e_ft_tpu/cli/run_geowizard.py` (GeoWizard's
`run_infer.py`): per image, saves depth npy + colored png + 16-bit png AND
normal npy + colored png; `--domain` selects the scene switcher
(indoor/outdoor/object). The pipeline runs on `--device` (default cuda).

    python -m diffusion_e2e_ft_tpu_torch.cli.run_geowizard --checkpoint <dir> \\
        --input_dir <dir> --output_dir <dir> --half_precision
"""

from __future__ import annotations

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
from diffusion_e2e_ft_tpu_torch.utils.logging import write_arguments
from diffusion_e2e_ft_tpu_torch.utils.seeding import seed_all


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--checkpoint", required=True, help="HF pipeline directory")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--domain", choices=["indoor", "outdoor", "object"], default="indoor")
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--noise", choices=["gaussian", "pyramid", "zeros"], default="zeros")
    p.add_argument("--processing_res", type=int, default=768)
    p.add_argument("--output_processing_res", action="store_true")
    p.add_argument("--half_precision", action="store_true", help="run in bfloat16")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--color_map", default="Spectral")
    add_device_argument(p, "the pipeline")
    return p


def main(argv=None):
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_all(args.seed if args.seed is not None else 0)

    dtype = torch.bfloat16 if args.half_precision else torch.float32
    pipe = GeoWizardPipeline.from_hf_dir(args.checkpoint, device=device, dtype=dtype)

    write_arguments(args.output_dir, vars(args))
    sub = {
        name: os.path.join(args.output_dir, name)
        for name in ("depth_npy", "depth_colored", "depth_bw", "normal_npy", "normal_colored")
    }
    for d in sub.values():
        os.makedirs(d, exist_ok=True)

    images = list_images(args.input_dir)
    if not images:
        raise SystemExit(f"no images found in {args.input_dir}")

    for path in images:
        out = pipe(
            load_image_rgb(path),
            denoising_steps=args.denoise_steps,
            ensemble_size=args.ensemble_size,
            processing_res=args.processing_res,
            match_input_res=not args.output_processing_res,
            noise=args.noise,
            domain=args.domain,
            seed=args.seed,
            color_map=args.color_map,
        )
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(sub["depth_npy"], f"{stem}_pred.npy"), out.depth_np)
        save_image(os.path.join(sub["depth_colored"], f"{stem}_colored.png"), out.depth_colored)
        save_image(os.path.join(sub["depth_bw"], f"{stem}_bw.png"), im.to_uint16(out.depth_np))
        np.save(os.path.join(sub["normal_npy"], f"{stem}_pred.npy"), out.normal_np)
        save_image(os.path.join(sub["normal_colored"], f"{stem}_colored.png"), out.normal_colored)
        print(f"[run] {stem} done", flush=True)


if __name__ == "__main__":
    main()
