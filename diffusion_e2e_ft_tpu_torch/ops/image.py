"""Image ops: aspect-preserving resize, normalization, colorization.

Port of `diffusion_e2e_ft_tpu/ops/image.py`. `resize` is
`F.interpolate(..., antialias=True, align_corners=False)`, which
`tests/test_resize_torch_parity.py` pins to the JAX resize at 1e-5; nearest
uses `nearest-exact` (half-pixel centres, as `jax.image.resize`).
Images are HWC or NHWC tensors, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_RESIZE_MODES = {
    "bilinear": "bilinear",
    "bicubic": "bicubic",
    "nearest": "nearest-exact",
    "nearest-exact": "nearest-exact",
}


def resize(
    img: torch.Tensor, out_hw: Tuple[int, int], method: str = "bilinear", antialias: bool = True
) -> torch.Tensor:
    """Resize an NHWC (or HWC) image stack to out_hw."""
    if img.ndim not in (3, 4):
        raise ValueError(f"Expected HWC or NHWC, got shape {tuple(img.shape)}")
    mode = _RESIZE_MODES.get(method)
    if mode is None:
        raise ValueError(f"Unknown resize method: {method}")
    x = (img[None] if img.ndim == 3 else img).permute(0, 3, 1, 2)
    if mode == "nearest-exact":
        out = F.interpolate(x, size=tuple(out_hw), mode=mode)
    else:
        out = F.interpolate(x, size=tuple(out_hw), mode=mode, antialias=antialias, align_corners=False)
    out = out.permute(0, 2, 3, 1)
    return out[0] if img.ndim == 3 else out


def max_edge_size(height: int, width: int, max_edge_resolution: int) -> Tuple[int, int]:
    """Target (h, w) limiting the longest edge while keeping aspect ratio."""
    factor = min(max_edge_resolution / width, max_edge_resolution / height)
    return int(height * factor), int(width * factor)


def resize_max_res(img: torch.Tensor, max_edge_resolution: int, method: str = "bilinear") -> torch.Tensor:
    """Resize so the longest edge equals max_edge_resolution (aspect preserved)."""
    h, w = (img.shape[0], img.shape[1]) if img.ndim == 3 else (img.shape[1], img.shape[2])
    return resize(img, max_edge_size(h, w, max_edge_resolution), method)


def normalize_rgb(img: torch.Tensor) -> torch.Tensor:
    """uint8-range [0, 255] -> [-1, 1] float32."""
    return img.float() / 255.0 * 2.0 - 1.0


def colorize_depth(
    depth: np.ndarray,
    min_depth: float = 0.0,
    max_depth: float = 1.0,
    cmap: str = "Spectral",
) -> np.ndarray:
    """Depth [H, W] -> float RGB [H, W, 3] in [0, 1] via a matplotlib colormap."""
    import matplotlib

    depth = np.asarray(depth, dtype=np.float32).squeeze()
    x = np.clip((depth - min_depth) / max(max_depth - min_depth, 1e-8), 0.0, 1.0)
    return matplotlib.colormaps[cmap](x)[..., :3].astype(np.float32)


def colorize_normals(normals: np.ndarray) -> np.ndarray:
    """Unit normals [H, W, 3] in [-1, 1] -> uint8 RGB."""
    n = np.asarray(normals, dtype=np.float32)
    return (((n + 1.0) * 0.5) * 255.0).clip(0, 255).astype(np.uint8)
