"""Depth benchmark runner: inference dump + metric evaluation, port of
`diffusion_e2e_ft_tpu/evaluation/depth_bench.py`.

`run_inference` runs a predict callable over a dataset in RGB-only mode and
dumps one `.npy` a frame, named by the dataset's filename mode, with an
`arguments.txt` record (Marigold's `infer.py`). `evaluate_predictions`
aligns each prediction to the GT (least squares in depth or disparity,
float64 on the host), clips it to the dataset's depth range and computes the
ten metrics on `device`, writing `per_sample_metrics.csv` and
`eval_metrics-<alignment>.txt` as the JAX package does (Marigold's
`eval.py`).
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.data.depth_eval import DatasetMode, DepthEvalDataset
from diffusion_e2e_ft_tpu_torch.evaluation import alignment as align_mod
from diffusion_e2e_ft_tpu_torch.evaluation import metrics as M
from diffusion_e2e_ft_tpu_torch.utils.logging import write_arguments


def run_inference(
    dataset: DepthEvalDataset,
    predict_fn: Callable[[np.ndarray], np.ndarray],  # rgb uint8 [H,W,3] -> depth [H,W]
    output_dir: str,
    arguments: Optional[Dict] = None,
    progress: bool = True,
) -> List[str]:
    """Run `predict_fn` over the dataset (RGB only) and dump per-image npy
    predictions named by the dataset's filename mode. Returns the saved paths."""
    os.makedirs(output_dir, exist_ok=True)
    if arguments is not None:
        write_arguments(output_dir, arguments)
    saved = []
    n = len(dataset)
    for i in range(n):
        sample = dataset[i]
        pred = np.asarray(predict_fn(sample["rgb_int"]), np.float32)
        path = os.path.join(output_dir, dataset.pred_name(i, ".npy"))
        np.save(path, pred)
        saved.append(path)
        if progress and (i % 50 == 0 or i == n - 1):
            print(f"[infer] {dataset.spec.name}: {i + 1}/{n}", flush=True)
    return saved


def evaluate_predictions(
    dataset: DepthEvalDataset,
    prediction_dir: str,
    output_dir: Optional[str] = None,
    alignment: str = "least_square",  # least_square | least_square_disparity
    alignment_max_res: Optional[int] = None,
    device="cpu",
) -> Dict[str, float]:
    """Align each prediction to GT, clip to the dataset depth range, compute the
    10-metric set on `device`; write per_sample_metrics.csv +
    eval_metrics-<alignment>.txt."""
    if dataset.mode == DatasetMode.RGB_ONLY:
        raise ValueError("dataset must be in EVAL mode")
    if alignment not in ("least_square", "least_square_disparity"):
        raise ValueError(f"Unknown alignment: {alignment}")
    tracker = M.MetricTracker(*M.DEPTH_METRIC_FUNCS.keys())
    rows = []
    for i in range(len(dataset)):
        sample = dataset[i]
        gt = sample["depth_raw_linear"]
        mask = sample["valid_mask_raw"]
        pred = np.load(os.path.join(prediction_dir, dataset.pred_name(i, ".npy")))

        if alignment == "least_square":
            aligned, _, _ = align_mod.align_depth_least_square(gt, pred, mask, max_resolution=alignment_max_res)
        else:
            gt_disp, gt_nonneg = align_mod.depth2disparity(gt, return_mask=True)
            aligned_disp, _, _ = align_mod.align_depth_least_square(
                gt_disp, pred, mask & gt_nonneg, max_resolution=alignment_max_res
            )
            aligned = align_mod.disparity2depth(aligned_disp)

        # clip to dataset range, then away from zero
        aligned = np.clip(aligned, dataset.spec.min_depth, dataset.spec.max_depth)
        aligned = np.clip(aligned, 1e-6, None)

        on_device = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (aligned, gt, mask)]
        row = {"sample": dataset.pred_name(i, ".npy")}
        for name, fn in M.DEPTH_METRIC_FUNCS.items():
            v = fn(*on_device)
            tracker.update(name, v)
            row[name] = v
        rows.append(row)

    results = tracker.result()
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "per_sample_metrics.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        with open(os.path.join(output_dir, f"eval_metrics-{alignment}.txt"), "w") as f:
            width = max(len(k) for k in results)
            for k, v in results.items():
                f.write(f"{k:<{width}}  {v:.8f}\n")
    return results
