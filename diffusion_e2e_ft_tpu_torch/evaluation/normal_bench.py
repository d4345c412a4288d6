"""Surface-normal benchmark runner (DSINE-style), port of
`diffusion_e2e_ft_tpu/evaluation/normal_bench.py`.

Iterate the benchmark datasets, call the predictor per image at native
resolution, pool per-pixel angular errors over ALL pixels of ALL images,
compute mean/median/rmse + 5/7.5/11.25/22.5/30-degree thresholds and write
`<name>_metrics.txt` a dataset, as DSINE's test script does. GeoWizard runs
get the per-dataset domain.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from diffusion_e2e_ft_tpu_torch.data.normal_eval import (
    GEOWIZARD_DOMAINS,
    NormalEvalDataset,
    get_normal_dataset,
)
from diffusion_e2e_ft_tpu_torch.evaluation import metrics as M

BENCHMARK_DATASETS = ("nyuv2", "scannet", "ibims", "sintel")


def evaluate_dataset(
    dataset: NormalEvalDataset,
    predict_fn: Callable[[np.ndarray, str], np.ndarray],
    # (rgb01 [H,W,3] float, domain) -> normal [H,W,3] in [-1,1]
    progress: bool = True,
) -> Dict[str, float]:
    """Pool per-pixel angular errors over the whole dataset."""
    domain = GEOWIZARD_DOMAINS[dataset.name]
    pooled: List[np.ndarray] = []
    n = len(dataset)
    for i in range(n):
        s = dataset[i]
        pred = np.asarray(predict_fn(s.img, domain), np.float32)
        if pred.shape != s.normal.shape:
            raise ValueError(
                f"prediction shape {pred.shape} != GT shape {s.normal.shape}"
            )
        err = M.normal_angular_error_deg(pred, s.normal)
        pooled.append(err[s.normal_mask])
        if progress and (i % 50 == 0 or i == n - 1):
            print(f"[normals] {dataset.name}: {i + 1}/{n}", flush=True)
    return M.normal_metrics(np.concatenate(pooled))


def dsine_padding(h: int, w: int, multiple: int = 32):
    """Centered (left, right, top, bottom) padding to the next /multiple — the DSINE
    NNET input protocol."""
    pw, ph = (-w) % multiple, (-h) % multiple
    left = pw // 2
    top = ph // 2
    return left, pw - left, top, ph - top


def nnet_predict_fn(
    model_fn: Callable[[np.ndarray], np.ndarray],
    multiple: int = 32,
) -> Callable[[np.ndarray, str], np.ndarray]:
    """Adapt a RAW normal-estimation network to the benchmark's predict signature —
    the generic non-diffusion NNET eval path (DSINE's baseline_normal test): center-pad the
    input to /32 with black, run `model_fn([1,H',W',3] in [0,1]) -> [1,H',W',3+K]`,
    crop the padded margin, drop any kappa (confidence) channels, unit-normalize.
    The GeoWizard domain argument is ignored (NNET baselines are domain-free)."""

    def predict(img01: np.ndarray, domain: str) -> np.ndarray:
        h, w = img01.shape[:2]
        l, r, t, b = dsine_padding(h, w, multiple)
        x = np.pad(img01[None], ((0, 0), (t, b), (l, r), (0, 0)))
        out = np.asarray(model_fn(x), np.float32)
        normal = out[0, t : t + h, l : l + w, :3]
        return normal / np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)

    return predict


def run_nnet_benchmark(
    base_data_dir: str,
    model_fn: Callable[[np.ndarray], np.ndarray],
    output_dir: str,
    datasets: Iterable[str] = BENCHMARK_DATASETS,
    split_paths: Optional[Dict[str, str]] = None,
) -> Dict[str, Dict[str, float]]:
    """baseline_normal-style benchmark of a raw network over the DSINE datasets."""
    return run_benchmark(
        base_data_dir, nnet_predict_fn(model_fn), output_dir, datasets, split_paths
    )


def run_benchmark(
    base_data_dir: str,
    predict_fn: Callable[[np.ndarray, str], np.ndarray],
    output_dir: str,
    datasets: Iterable[str] = BENCHMARK_DATASETS,
    split_paths: Optional[Dict[str, str]] = None,
) -> Dict[str, Dict[str, float]]:
    """Evaluate every benchmark dataset; write one metrics.txt per dataset."""
    os.makedirs(output_dir, exist_ok=True)
    all_results: Dict[str, Dict[str, float]] = {}
    for name in datasets:
        ds = get_normal_dataset(
            name, base_data_dir, (split_paths or {}).get(name)
        )
        results = evaluate_dataset(ds, predict_fn)
        all_results[name] = results
        with open(os.path.join(output_dir, f"{name}_metrics.txt"), "w") as f:
            header = " ".join(f"{k:>8}" for k in results)
            values = " ".join(f"{v:8.3f}" for v in results.values())
            f.write(header + "\n" + values + "\n")
    return all_results
