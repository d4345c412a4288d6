"""Depth metric evaluation CLI: align dumped predictions to GT and compute the
10-metric set.

Port of `diffusion_e2e_ft_tpu/cli/eval_depth.py` (Marigold's `eval.py`):
least-squares or disparity-space alignment, dataset-range clipping,
`per_sample_metrics.csv` + `eval_metrics-<alignment>.txt`. The metrics run
on `--device` (default cuda).

    python -m diffusion_e2e_ft_tpu_torch.cli.eval_depth @args.txt --device cuda
"""

from __future__ import annotations

from diffusion_e2e_ft_tpu_torch.cli.common import add_device_argument, load_dataset_config, make_parser, resolve_device
from diffusion_e2e_ft_tpu_torch.data.depth_eval import DatasetMode, get_depth_dataset
from diffusion_e2e_ft_tpu_torch.evaluation.depth_bench import evaluate_predictions


def build_parser():
    p = make_parser(__doc__)
    p.add_argument("--dataset_config", required=True)
    p.add_argument("--base_data_dir", required=True)
    p.add_argument("--prediction_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument(
        "--alignment",
        choices=["least_square", "least_square_disparity"],
        default="least_square",
    )
    p.add_argument("--alignment_max_res", type=int, default=None)
    add_device_argument(p, "the metrics")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_dataset_config(args.dataset_config)
    dataset = get_depth_dataset(cfg, args.base_data_dir, DatasetMode.EVAL)
    results = evaluate_predictions(
        dataset,
        args.prediction_dir,
        args.output_dir,
        alignment=args.alignment,
        alignment_max_res=args.alignment_max_res,
        device=device,
    )
    width = max(len(k) for k in results)
    for k, v in results.items():
        print(f"{k:<{width}}  {v:.6f}")
    return results


if __name__ == "__main__":
    main()
