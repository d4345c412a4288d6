"""Camera geometry: intrinsics algebra, pixel-ray arrays, rotations, and
depth/normal visualization helpers.

The port's own copy of `diffusion_e2e_ft_tpu/utils/geometry.py`: host numpy
on [3, 3] matrices and HWC arrays, as the data code is (intrinsics from FOV,
crop/resize-aware intrinsics updates, ray arrays, Euler / axis-angle
rotation matrices, the FOV-preserving warp through cv2, normal->RGB and
depth->RGB rendering, the latter with the port's own Spectral table).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Intrinsics
# ---------------------------------------------------------------------------


def intrins_from_fov(fov_deg: float, height: int, width: int) -> np.ndarray:
    """Pinhole K from a DIAGONAL field of view (DSINE's convention)."""
    diag = math.sqrt(height**2 + width**2)
    f = 0.5 * diag / math.tan(0.5 * math.radians(fov_deg))
    return np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]], np.float64
    )


def intrins_crop(K: np.ndarray, left: float, top: float) -> np.ndarray:
    out = np.array(K, np.float64)
    out[0, 2] -= left
    out[1, 2] -= top
    return out


def intrins_pad(K: np.ndarray, left: float, top: float) -> np.ndarray:
    return intrins_crop(K, -left, -top)


def intrins_scale(K: np.ndarray, sx: float, sy: float) -> np.ndarray:
    out = np.array(K, np.float64)
    out[0, 0] *= sx
    out[0, 2] *= sx
    out[1, 1] *= sy
    out[1, 2] *= sy
    return out


def ray_array(K: np.ndarray, height: int, width: int, normalize: bool = False) -> np.ndarray:
    """[H, W, 3] camera rays through pixel centers (+0.5)."""
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    xs, ys = np.meshgrid(
        np.arange(width, dtype=np.float64) + 0.5,
        np.arange(height, dtype=np.float64) + 0.5,
    )
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    rays = pix @ Kinv.T
    if normalize:
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays.astype(np.float32)


def unproject_depth(depth: np.ndarray, K: np.ndarray) -> np.ndarray:
    """[H, W] planar depth -> [H, W, 3] camera-frame points."""
    h, w = depth.shape
    rays = ray_array(K, h, w)
    return rays * np.asarray(depth, np.float32)[..., None]


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------


def rotation_euler(rx: float, ry: float, rz: float, degrees: bool = True) -> np.ndarray:
    """R = Rz @ Ry @ Rx."""
    if degrees:
        rx, ry, rz = map(math.radians, (rx, ry, rz))
    cx, sx = math.cos(rx), math.sin(rx)
    cy, sy = math.cos(ry), math.sin(ry)
    cz, sz = math.cos(rz), math.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float64)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float64)
    return Rz @ Ry @ Rx


def rotation_axis_angle(axis: np.ndarray, angle: float, degrees: bool = True) -> np.ndarray:
    """Rodrigues' formula."""
    if degrees:
        angle = math.radians(angle)
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], np.float64
    )
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotate_normals(normal: np.ndarray, R: np.ndarray) -> np.ndarray:
    """[..., 3] normals rotated by R."""
    return np.asarray(normal) @ np.asarray(R, normal.dtype).T


# ---------------------------------------------------------------------------
# Perspective warps (DSINE's FOV-preserving warp)
# ---------------------------------------------------------------------------


def homography_warp(
    img: np.ndarray, K_src: np.ndarray, K_dst: np.ndarray, R: np.ndarray,
    out_hw: Optional[Tuple[int, int]] = None, nearest: bool = False,
) -> np.ndarray:
    """Warp by the plane-at-infinity homography H = K_dst R^T K_src^-1."""
    import cv2

    h, w = out_hw or img.shape[:2]
    H = np.asarray(K_dst) @ np.asarray(R).T @ np.linalg.inv(np.asarray(K_src))
    flags = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.warpPerspective(np.asarray(img), H.astype(np.float64), (w, h), flags=flags)


# ---------------------------------------------------------------------------
# Visualization
# ---------------------------------------------------------------------------


def normal_to_rgb(normal: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """[-1, 1] normals -> uint8 RGB; invalid pixels black."""
    rgb = (((np.asarray(normal, np.float32) + 1.0) * 0.5) * 255.0).clip(0, 255).astype(np.uint8)
    if mask is not None:
        rgb[~np.asarray(mask, bool)] = 0
    return rgb


def depth_to_rgb(
    depth: np.ndarray, mask: Optional[np.ndarray] = None, cmap: str = "Spectral"
) -> np.ndarray:
    """Min-max normalized depth -> uint8 RGB via a colormap; invalid pixels black."""
    from diffusion_e2e_ft_tpu_torch.ops.image import colorize_depth

    d = np.asarray(depth, np.float32)
    valid = np.ones_like(d, bool) if mask is None else np.asarray(mask, bool)
    lo = d[valid].min() if valid.any() else 0.0
    hi = d[valid].max() if valid.any() else 1.0
    rgb = colorize_depth(d, lo, max(hi, lo + 1e-8), cmap=cmap)
    rgb[~valid.squeeze()] = 0.0
    return (rgb * 255).astype(np.uint8)
