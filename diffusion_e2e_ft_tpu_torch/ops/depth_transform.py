"""Depth normalization transforms, port of `diffusion_e2e_ft_tpu/ops/depth_transform.py`.

`NearFarMetricNormalizer` (Marigold's `src/util/depth_transform.py:49-99`):
map metric depth to [-1, 1] by the 2%/98% quantiles of the valid pixels,
clip outliers, and remember the transform so predictions can be
de-normalized back to metric scale. In torch on the input's device;
`torch.quantile`'s default linear interpolation is `np.quantile`'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class NearFarMetricNormalizer:
    """[-1, 1] quantile normalizer with invertible scale/shift per call."""

    is_absolute = False
    far_plane_at_max = True

    def __init__(
        self,
        norm_min: float = -1.0,
        norm_max: float = 1.0,
        min_max_quantile: float = 0.02,
        clip: bool = True,
    ):
        self.norm_min = norm_min
        self.norm_max = norm_max
        self.norm_range = norm_max - norm_min
        self.min_quantile = min_max_quantile
        self.max_quantile = 1.0 - min_max_quantile
        self.clip = clip

    def __call__(
        self, depth, valid_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, float, float]:
        """Returns (normalized float32 depth on the input's device, d_min,
        d_max); invert with `denormalize`."""
        depth = torch.as_tensor(depth).float()
        valid = depth > 0
        if valid_mask is not None:
            valid &= torch.as_tensor(valid_mask, device=depth.device).bool()
        flat = depth[valid]
        if flat.numel() == 0:
            return torch.zeros_like(depth), 0.0, 1.0
        q = torch.tensor([self.min_quantile, self.max_quantile], dtype=flat.dtype, device=flat.device)
        d_min, d_max = (float(v) for v in torch.quantile(flat, q))
        denom = max(d_max - d_min, 1e-8)
        out = (depth - d_min) / denom * self.norm_range + self.norm_min
        if self.clip:
            out = out.clamp(self.norm_min, self.norm_max)
        return out, d_min, d_max

    def denormalize(self, normalized, d_min: float, d_max: float) -> torch.Tensor:
        return (torch.as_tensor(normalized).float() - self.norm_min) / self.norm_range * (d_max - d_min) + d_min
