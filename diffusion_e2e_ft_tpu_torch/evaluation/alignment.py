"""Affine alignment of affine-invariant depth predictions to metric ground
truth: the port's copy of `diffusion_e2e_ft_tpu/evaluation/alignment.py`.

Masked least squares on the valid pixels (optionally at reduced resolution),
applied to the full-resolution prediction, as Marigold's eval does. Host
numpy in float64 (`np.linalg.lstsq`), as the JAX package computes it: the
(scale, shift) of the two packages agree to rounding.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _nearest_downsample(x: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbor downsample by a uniform scale factor (align_corners=False
    half-pixel sampling, matching torch Upsample(mode='nearest'))."""
    h, w = x.shape[-2:]
    nh, nw = int(h * scale), int(w * scale)
    rows = np.minimum((np.arange(nh) / scale).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(nw) / scale).astype(np.int64), w - 1)
    return x[..., rows[:, None], cols[None, :]]


def align_depth_least_square(
    gt_arr: np.ndarray,
    pred_arr: np.ndarray,
    valid_mask_arr: np.ndarray,
    return_scale_shift: bool = True,
    max_resolution: Optional[int] = None,
):
    """Least-squares (scale, shift) aligning pred to gt over the valid mask; returns
    the aligned full-resolution prediction (and the transform)."""
    ori_shape = pred_arr.shape
    gt = np.asarray(gt_arr).squeeze()
    pred = np.asarray(pred_arr).squeeze()
    mask = np.asarray(valid_mask_arr).squeeze().astype(bool)

    if max_resolution is not None:
        scale_factor = float(np.min(max_resolution / np.array(gt.shape[-2:])))
        if scale_factor < 1:
            gt = _nearest_downsample(gt, scale_factor)
            pred = _nearest_downsample(pred, scale_factor)
            mask = _nearest_downsample(mask.astype(np.float32), scale_factor).astype(bool)

    if gt.shape != pred.shape or gt.shape != mask.shape:
        raise ValueError(f"shape mismatch: {gt.shape} vs {pred.shape} vs {mask.shape}")

    pm = pred[mask].astype(np.float64).reshape(-1, 1)
    gm = gt[mask].astype(np.float64).reshape(-1, 1)
    A = np.concatenate([pm, np.ones_like(pm)], axis=-1)
    X, *_ = np.linalg.lstsq(A, gm, rcond=None)
    scale, shift = float(X[0, 0]), float(X[1, 0])

    aligned = (np.asarray(pred_arr) * scale + shift).reshape(ori_shape)
    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def depth2disparity(depth: np.ndarray, return_mask: bool = False):
    """1/d on positive depths, 0 elsewhere."""
    depth = np.asarray(depth)
    disparity = np.zeros_like(depth)
    positive = depth > 0
    disparity[positive] = 1.0 / depth[positive]
    if return_mask:
        return disparity, positive
    return disparity


def disparity2depth(disparity: np.ndarray, **kwargs):
    return depth2disparity(disparity, **kwargs)
