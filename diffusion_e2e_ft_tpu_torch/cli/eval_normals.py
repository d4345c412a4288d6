"""Surface-normal benchmark CLI (DSINE-style).

Port of `diffusion_e2e_ft_tpu/cli/eval_normals.py` (DSINE's
`projects/dsine/test.py --mode benchmark`): iterate the benchmark datasets
at native resolution, pool angular errors, write `<name>_metrics.txt` a
dataset; GeoWizard gets the per-dataset domain. The pipeline runs on
`--device` (default cuda). `--split_paths name=path ...` reads a dataset's
samples from another split list than the vendored one (a local tree).

    python -m diffusion_e2e_ft_tpu_torch.cli.eval_normals @args.txt --device cuda
"""

from __future__ import annotations

import numpy as np

from diffusion_e2e_ft_tpu_torch.cli.common import add_device_argument, make_parser, resolve_device
from diffusion_e2e_ft_tpu_torch.cli.infer import load_pipeline
from diffusion_e2e_ft_tpu_torch.evaluation.normal_bench import BENCHMARK_DATASETS, run_benchmark
from diffusion_e2e_ft_tpu_torch.utils.seeding import seed_all


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model_type", choices=["marigold", "geowizard"], default="marigold")
    p.add_argument("--base_data_dir", required=True, help="contains dsine_eval/<name>")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--eval_data", nargs="+", default=list(BENCHMARK_DATASETS))
    p.add_argument("--split_paths", nargs="*", default=[], metavar="NAME=PATH",
                   help="split list per dataset (default: the vendored one, else <dataset>/test.txt)")
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--ensemble_size", type=int, default=1)
    p.add_argument("--processing_res", type=int, default=0)
    p.add_argument("--noise", choices=["gaussian", "pyramid", "zeros"], default="zeros")
    p.add_argument("--timestep_spacing", default=None)
    p.add_argument("--half_precision", action="store_true", help="run in bfloat16")
    p.add_argument("--seed", type=int, default=1234)
    add_device_argument(p, "the pipeline")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    seed_all(args.seed)
    split_paths = dict(item.split("=", 1) for item in args.split_paths)
    pipe = load_pipeline(args, device)
    common = dict(denoising_steps=args.denoise_steps, ensemble_size=args.ensemble_size,
                  processing_res=args.processing_res, noise=args.noise, seed=args.seed, color_map=None)
    if args.model_type == "marigold":

        def predict(img01, domain):
            return pipe((np.asarray(img01) * 255).astype(np.uint8), normals=True, **common).normal_np

    else:

        def predict(img01, domain):
            return pipe((np.asarray(img01) * 255).astype(np.uint8), domain=domain, **common).normal_np

    results = run_benchmark(args.base_data_dir, predict, args.output_dir, datasets=args.eval_data,
                            split_paths=split_paths)
    for name, m in results.items():
        print(name, {k: round(v, 3) for k, v in m.items()})
    return results


if __name__ == "__main__":
    main()
