"""Depth and surface-normal evaluation metrics, port of
`diffusion_e2e_ft_tpu/evaluation/metrics.py`.

The ten depth metrics are torch functions on float32 tensors, computed on
the device of their inputs (numpy inputs go to the CPU): masked
where-sums, averaged per image over its valid pixels and then over the
batch, as the JAX package does (`log10` pools every valid pixel of the
batch). They take [B, H, W] or [H, W] arrays plus a boolean valid mask and
return a python float.

The normal metrics stay numpy, with numpy's semantics: `np.median` of an
even count averages the two middle values, where `torch.median` would
return the lower one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _prep(output, target, valid_mask):
    o = torch.as_tensor(output).float()
    t = torch.as_tensor(target).float().to(o.device)
    m = torch.ones_like(o, dtype=torch.bool) if valid_mask is None else torch.as_tensor(valid_mask).to(o.device, torch.bool)
    if o.ndim == 2:
        o, t, m = o[None], t[None], m[None]
    return o, t, m


def _masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, values, 0.0).sum(dim=(-1, -2))


def _per_image_mean(values, mask) -> float:
    """sum over valid pixels / n_valid, per image; then mean over the batch."""
    return float((_masked_sum(values, mask) / mask.sum(dim=(-1, -2))).mean())


def _per_image_rms(diff, mask) -> float:
    """sqrt(mean over valid pixels of diff²), per image; then mean over the batch."""
    return float((_masked_sum(diff**2, mask) / mask.sum(dim=(-1, -2))).sqrt().mean())


def abs_relative_difference(output, target, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    return _per_image_mean((o - t).abs() / t, m)


def squared_relative_difference(output, target, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    return _per_image_mean((o - t) ** 2 / t, m)


def rmse_linear(output, target, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    return _per_image_rms(o - t, m)


def rmse_log(output, target, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    return _per_image_rms(torch.where(m, o.log() - t.log(), 0.0), m)


def log10(output, target, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    # pools ALL valid pixels of the batch, as the reference does
    d = (o.log10() - t.log10()).abs()
    return float(torch.where(m, d, 0.0).sum() / m.sum())


def threshold_percentage(output, target, threshold_val, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    ratio = torch.maximum(o / t, t / o)
    return _per_image_mean((ratio < threshold_val).float(), m)


def delta1_acc(pred, gt, valid_mask=None) -> float:
    return threshold_percentage(pred, gt, 1.25, valid_mask)


def delta2_acc(pred, gt, valid_mask=None) -> float:
    return threshold_percentage(pred, gt, 1.25**2, valid_mask)


def delta3_acc(pred, gt, valid_mask=None) -> float:
    return threshold_percentage(pred, gt, 1.25**3, valid_mask)


def i_rmse(output, target, valid_mask=None) -> float:
    o, t, m = _prep(output, target, valid_mask)
    return _per_image_rms(torch.where(m, 1.0 / o - 1.0 / t, 0.0), m)


def silog_rmse(depth_pred, depth_gt, valid_mask=None) -> float:
    o, t, m = _prep(depth_pred, depth_gt, valid_mask)
    d = torch.where(m, o.log() - t.log(), 0.0)
    n = m.sum(dim=(-1, -2))
    first = (d**2).sum(dim=(-1, -2)) / n
    second = d.sum(dim=(-1, -2)) ** 2 / n**2
    # fp cancellation can push the variance a hair below zero on near-constant input
    return float((first - second).mean().clamp_min(0.0).sqrt() * 100.0)


DEPTH_METRIC_FUNCS = {
    "abs_relative_difference": abs_relative_difference,
    "squared_relative_difference": squared_relative_difference,
    "rmse_linear": rmse_linear,
    "rmse_log": rmse_log,
    "log10": log10,
    "delta1_acc": delta1_acc,
    "delta2_acc": delta2_acc,
    "delta3_acc": delta3_acc,
    "i_rmse": i_rmse,
    "silog_rmse": silog_rmse,
}


class MetricTracker:
    """Running weighted averages keyed by metric name."""

    def __init__(self, *keys: str):
        self._keys = list(keys)
        self.reset()

    def reset(self) -> None:
        self._total = {k: 0.0 for k in self._keys}
        self._count = {k: 0 for k in self._keys}

    def update(self, key: str, value: float, n: int = 1) -> None:
        if key not in self._total:
            self._keys.append(key)
            self._total[key] = 0.0
            self._count[key] = 0
        self._total[key] += float(value) * n
        self._count[key] += n

    def avg(self, key: str) -> float:
        return self._total[key] / max(self._count[key], 1)

    def result(self) -> Dict[str, float]:
        return {k: self.avg(k) for k in self._keys}


# ---------------------------------------------------------------------------
# Surface normals (DSINE-style), numpy
# ---------------------------------------------------------------------------


def normal_angular_error_deg(pred_norm, gt_norm) -> np.ndarray:
    """Per-pixel angular error in degrees; inputs [..., 3] unit-ish normals."""
    p = np.asarray(pred_norm, np.float32)
    g = np.asarray(gt_norm, np.float32)
    cos = np.sum(p * g, axis=-1) / (np.linalg.norm(p, axis=-1) * np.linalg.norm(g, axis=-1) + 1e-12)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def normal_metrics(total_errors_deg: np.ndarray) -> Dict[str, float]:
    """Pooled (all pixels of all images) benchmark metrics: mean/median/rmse +
    sub-threshold percentages at 5/7.5/11.25/22.5/30 degrees."""
    e = np.asarray(total_errors_deg, np.float32).reshape(-1)
    n = e.shape[0]
    return {
        "mean": float(np.mean(e)),
        "median": float(np.median(e)),
        "rmse": float(np.sqrt(np.sum(e * e) / n)),
        "a1": 100.0 * float(np.sum(e < 5) / n),
        "a2": 100.0 * float(np.sum(e < 7.5) / n),
        "a3": 100.0 * float(np.sum(e < 11.25) / n),
        "a4": 100.0 * float(np.sum(e < 22.5) / n),
        "a5": 100.0 * float(np.sum(e < 30) / n),
    }
