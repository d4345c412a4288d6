"""Task-space losses, port of `diffusion_e2e_ft_tpu/ops/losses.py`:
scale-and-shift-invariant depth L1 and the angular normal loss.

Every masked statistic is a where-sum (sum(x * m) / sum(m)) over static
shapes, as in the JAX package, so the values match its and the reference's
boolean-indexed means. The losses run in an fp32 island whatever the input
dtype, and the 2x2 scale/shift solve returns (0, 0) for images whose system
is not positive definite (det <= 0).

Conventions (NHWC, as the JAX package):
  depth prediction/target: [B, H, W]    mask: [B, H, W] bool
  normal prediction/target: [B, H, W, 3] mask: [B, H, W] bool
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def compute_scale_and_shift(
    prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form least-squares (scale, shift) aligning prediction to target per image."""
    p, y, m = prediction.float(), target.float(), mask.float()
    dims = (1, 2)
    a00 = (m * p * p).sum(dims)
    a01 = (m * p).sum(dims)
    a11 = m.sum(dims)
    b0 = (m * p * y).sum(dims)
    b1 = (m * y).sum(dims)
    det = a00 * a11 - a01 * a01
    valid = det > 0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    scale = torch.where(valid, (a11 * b0 - a01 * b1) / safe_det, zero)
    shift = torch.where(valid, (-a01 * b0 + a00 * b1) / safe_det, zero)
    return scale, shift


def ssi_loss(
    prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, count: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Scale-and-shift-invariant L1 depth loss, mean over all valid pixels in the batch.

    `count` replaces the batch's own valid-pixel count as the divisor: a
    data-parallel rank passes the global batch's, so the ranks' losses sum to
    the global mean."""
    if prediction.ndim == 4:
        prediction = prediction.squeeze(-1)
    if target.ndim == 4:
        target = target.squeeze(-1)
    if mask.ndim == 4:
        mask = mask.squeeze(-1)
    p, y, m = prediction.float(), target.float(), mask.float()
    scale, shift = compute_scale_and_shift(p, y, m)
    aligned = scale[:, None, None] * p + shift[:, None, None]
    abs_err = (aligned - y).abs() * m
    return abs_err.sum() / (m.sum() if count is None else count).clamp_min(1.0)


def angular_loss(
    prediction: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, count: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean angular error (radians) between unit normal fields over valid
    pixels; `count` as in `ssi_loss`."""
    p, y = prediction.float(), target.float()
    if mask.ndim == 4:
        mask = mask[..., 0]
    m = mask.float()
    dot = (p * y).sum(-1).clamp(-1.0, 1.0)
    return (torch.arccos(dot) * m).sum() / (m.sum() if count is None else count).clamp_min(1.0)


def nan_guarded(loss: torch.Tensor) -> torch.Tensor:
    """Replace a NaN loss with 0, so a degenerate batch contributes no gradient step."""
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
