"""Image ops: aspect-preserving resize, normalization, padding,
colorization, 16-bit export.

Port of `diffusion_e2e_ft_tpu/ops/image.py`. `resize` is
`F.interpolate(..., antialias=True, align_corners=False)`, which
`tests/test_resize_torch_parity.py` pins to the JAX resize at 1e-5; nearest
uses `nearest-exact` (half-pixel centres, as `jax.image.resize`).
Images are HWC or NHWC tensors, as in the JAX package.
"""

from __future__ import annotations

import functools
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


def denormalize_rgb(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 255]."""
    return (img + 1.0) / 2.0 * 255.0


def pad_to_multiple(img: torch.Tensor, multiple: int = 32) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pad bottom/right so H and W divide `multiple` (HWC or NHWC);
    returns (padded, orig_hw). The DSINE benchmark's pad-to-/32."""
    h, w = img.shape[-3], img.shape[-2]
    rows = torch.arange(h + -h % multiple, device=img.device).clamp_max(h - 1)
    cols = torch.arange(w + -w % multiple, device=img.device).clamp_max(w - 1)
    return img.index_select(-3, rows).index_select(-2, cols), (h, w)


def unpad(img: torch.Tensor, orig_hw: Tuple[int, int]) -> torch.Tensor:
    h, w = orig_hw
    if img.ndim == 3:
        return img[:h, :w, :]
    return img[:, :h, :w, :]


# ColorBrewer's 11-class Spectral scheme (8-bit RGB), the colours matplotlib's "Spectral" interpolates
_SPECTRAL = ("9e0142", "d53e4f", "f46d43", "fdae61", "fee08b", "ffffbf", "e6f598", "abdda4", "66c2a5", "3288bd",
             "5e4fa2")


@functools.lru_cache(maxsize=None)
def _spectral_lut(n: int = 256) -> np.ndarray:
    """[n, 3] float64 table of matplotlib's "Spectral" (a colour list spread
    evenly over [0, 1], linearly interpolated), built as matplotlib builds it,
    so that the port needs neither matplotlib nor PIL, which it imports."""
    colors = np.array([[int(h[i : i + 2], 16) / 255.0 for i in (0, 2, 4)] for h in _SPECTRAL])
    x = np.linspace(0.0, 1.0, len(colors)) * (n - 1)
    xind = (n - 1) * np.linspace(0.0, 1.0, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = ((xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1]))[:, None]
    lut = np.concatenate([colors[:1], distance * (colors[ind] - colors[ind - 1]) + colors[ind - 1], colors[-1:]])
    return np.clip(lut, 0.0, 1.0)


def colorize_depth(
    depth: np.ndarray,
    min_depth: float = 0.0,
    max_depth: float = 1.0,
    cmap: str = "Spectral",
) -> np.ndarray:
    """Depth [H, W] -> float RGB [H, W, 3] in [0, 1] via a colormap:
    "Spectral" from the port's own table (the same values as matplotlib's),
    any other through matplotlib."""
    depth = np.asarray(depth, dtype=np.float32).squeeze()
    x = np.clip((depth - min_depth) / max(max_depth - min_depth, 1e-8), 0.0, 1.0)
    if cmap != "Spectral":
        import matplotlib

        return matplotlib.colormaps[cmap](x)[..., :3].astype(np.float32)
    lut = _spectral_lut()
    index = x * len(lut)  # matplotlib's lookup: floor(x * N), x = 1 to the last entry
    return lut[np.minimum(index, len(lut) - 1).astype(np.int64)].astype(np.float32)


def colorize_normals(normals: np.ndarray) -> np.ndarray:
    """Unit normals [H, W, 3] in [-1, 1] -> uint8 RGB."""
    n = np.asarray(normals, dtype=np.float32)
    return (((n + 1.0) * 0.5) * 255.0).clip(0, 255).astype(np.uint8)


def to_uint16(depth01: np.ndarray) -> np.ndarray:
    """[0, 1] depth -> 16-bit png payload (the reference's export format)."""
    return (np.asarray(depth01, np.float32) * 65535.0).astype(np.uint16)


def chw2hwc(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), 0, -1)


def hwc2chw(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -1, 0)
