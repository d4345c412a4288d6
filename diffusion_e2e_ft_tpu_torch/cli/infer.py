"""Eval-dataset inference CLI: run a pipeline over a benchmark dataset (RGB only)
and dump per-image `.npy` predictions for `eval_depth`.

Port of `diffusion_e2e_ft_tpu/cli/infer.py` (Marigold's `infer.py`): a
dataset-config YAML, RGB-only reads, one npy a frame named by the dataset's
filename mode, an `arguments.txt` record; `--model_type geowizard` switches
pipeline (with `--domain`). The pipeline runs on `--device` (default cuda),
in bf16 under `--half_precision`.

    python -m diffusion_e2e_ft_tpu_torch.cli.infer @args.txt --device cuda
"""

from __future__ import annotations

import torch

from diffusion_e2e_ft_tpu_torch.cli.common import add_device_argument, load_dataset_config, make_parser, resolve_device
from diffusion_e2e_ft_tpu_torch.data.depth_eval import DatasetMode, get_depth_dataset
from diffusion_e2e_ft_tpu_torch.evaluation.depth_bench import run_inference
from diffusion_e2e_ft_tpu_torch.utils.seeding import seed_all


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model_type", choices=["marigold", "geowizard"], default="marigold")
    p.add_argument("--dataset_config", required=True, help="dataset YAML (name/dir/filenames)")
    p.add_argument("--base_data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--processing_res", type=int, default=0, help="0 = native resolution")
    p.add_argument("--noise", choices=["gaussian", "pyramid", "zeros"], default="zeros")
    p.add_argument("--timestep_spacing", choices=["trailing", "leading", "linspace"], default=None)
    p.add_argument("--domain", choices=["indoor", "outdoor", "object"], default="indoor")
    p.add_argument("--half_precision", action="store_true", help="run in bfloat16")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--resample_method", default="bilinear")
    add_device_argument(p, "the pipeline")
    return p


def load_pipeline(args, device):
    """The CLI's Marigold or GeoWizard pipeline on `device`, bf16 under
    `--half_precision`, with `--timestep_spacing` applied."""
    dtype = torch.bfloat16 if args.half_precision else torch.float32
    if args.model_type == "marigold":
        from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

        pipe = MarigoldPipeline.from_hf_dir(args.checkpoint, device=device, dtype=dtype)
    else:
        from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline

        pipe = GeoWizardPipeline.from_hf_dir(args.checkpoint, device=device, dtype=dtype)
    if args.timestep_spacing is not None:
        pipe.scheduler_config = pipe.scheduler_config.replace(timestep_spacing=args.timestep_spacing)
    return pipe


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_all(args.seed)

    cfg = load_dataset_config(args.dataset_config)
    dataset = get_depth_dataset(cfg, args.base_data_dir, DatasetMode.RGB_ONLY)
    pipe = load_pipeline(args, device)
    common = dict(denoising_steps=args.denoise_steps, ensemble_size=args.ensemble_size,
                  processing_res=args.processing_res, noise=args.noise, seed=args.seed, color_map=None)
    if args.model_type == "marigold":

        def predict(rgb):
            return pipe(rgb, resample_method=args.resample_method, **common).depth_np

    else:

        def predict(rgb):
            return pipe(rgb, domain=args.domain, **common).depth_np

    run_inference(dataset, predict, args.output_dir, arguments=vars(args))


if __name__ == "__main__":
    main()
