"""Depth -> surface-normal translation with discontinuity-aware gradients (D2NT),
port of `diffusion_e2e_ft_tpu/tools/depth_to_normal.py` in torch, float64, on
a device (default the card).

As the depth-to-normal translator's d2nt_v3 pipeline, which made VKITTI's GT
normals: one-sided depth gradients blended by a soft-min over local Laplacian
magnitudes (so gradients never straddle a depth discontinuity), normal =
(Gu*fx, Gv*fy, -(z + v*Gv + u*Gu)) in the (u-u0, v-v0) pixel frame, an MRF
refinement that replaces each normal with the neighbor whose depth is locally
smoothest, and a camera-facing flip.

The arithmetic is the JAX tool's, operation for operation (`pow` for the
soft-min, the norm as the square root of ((x² + y²) + z²)), so that the two
agree to float64 rounding and a rounding cannot flip the soft-min's snap.
The MRF choice takes the first of equal costs, as `np.argmin` does, by an
explicit rule rather than `torch.argmin` (whose tie order on CUDA is not
documented): on a plane every cost is 0 and the pixel keeps its left
neighbour's normal on both devices.

Normals are stored as 16-bit RGB PNGs (`(n + 1) * 32767.5`, truncated),
written and read through `data/image_io.py`: the bytes on disk are RGB, as
the JAX tool's cv2 files (whose BGR swap undoes cv2's own) are.
"""

from __future__ import annotations

import os
from typing import Literal, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.data import image_io

Version = Literal["basic", "v2", "v3"]

VKITTI_INTRINSICS = (725.0087, 725.0087, 620.5, 187.0)  # fx, fy, cx, cy
MRF_CANDIDATES = ((0, -1), (0, 1), (-1, 0), (1, 0))  # left, right, up, down; then the pixel itself


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with reflect-101 border (the OpenCV default): out[y,x] = a[y+dy, x+dx]."""
    h, w = a.shape
    pad = max(abs(dy), abs(dx))
    p = F.pad(a[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]
    return p[pad + dy : pad + dy + h, pad + dx : pad + dx + w]


def _fill_shift(a: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """Shift over the first two dims, vacated cells `fill`: out[y,x] = a[y+dy, x+dx] or fill."""
    out = torch.full_like(a, fill)
    h, w = a.shape[:2]
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


def one_sided_gradients(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(left, right, up, down) one-sided depth differences."""
    grad_l = z - _shift(z, 0, -1)
    grad_r = _shift(z, 0, 1) - z
    grad_u = z - _shift(z, -1, 0)
    grad_d = _shift(z, 1, 0) - z
    return grad_l, grad_r, grad_u, grad_d


def central_gradients(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference Gu, Gv (the 'basic' non-discontinuity-aware filter)."""
    gu = (_shift(z, 0, 1) - _shift(z, 0, -1)) / 2.0
    gv = (_shift(z, 1, 0) - _shift(z, -1, 0)) / 2.0
    return gu, gv


def _soft_min_weights(lap: torch.Tensor, axis: int, base: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend weights favoring the side with the smaller neighboring Laplacian.

    axis 0: horizontal (left/right neighbors along x); axis 1: vertical."""
    eps = 1e-8
    p = torch.pow(base, -lap)
    (ny, nx), (py, px) = ((0, -1), (0, 1)) if axis == 0 else ((-1, 0), (1, 0))
    p_neg, p_pos = _fill_shift(p, ny, nx, 0.0), _fill_shift(p, py, px, 0.0)
    w_neg = (p_neg + eps * 0.5) / (eps + p_neg + p_pos)
    w_pos = (p_pos + eps * 0.5) / (eps + p_neg + p_pos)
    # snap to hard selection when one side dominates by more than `base`
    dominant_neg = w_neg / (w_pos + eps) > base
    dominant_pos = w_pos / (w_neg + eps) > base
    one, zero = torch.ones_like(w_neg), torch.zeros_like(w_neg)
    w_neg_out = torch.where(dominant_neg, one, torch.where(dominant_pos, zero, w_neg))
    w_pos_out = torch.where(dominant_neg, zero, torch.where(dominant_pos, one, w_pos))
    return w_neg_out, w_pos_out


def dag_gradients(z: torch.Tensor, base: float = float(np.e)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discontinuity-aware Gu, Gv: per-pixel soft-min blend of one-sided gradients."""
    grad_l, grad_r, grad_u, grad_d = one_sided_gradients(z)
    lap_hor = torch.abs(grad_l - grad_r)
    lap_ver = torch.abs(grad_u - grad_d)
    w_l, w_r = _soft_min_weights(lap_hor, 0, base)
    w_u, w_d = _soft_min_weights(lap_ver, 1, base)
    return w_l * grad_l + w_r * grad_r, w_u * grad_u + w_d * grad_d


def _depth(depth, device) -> torch.Tensor:
    if isinstance(depth, torch.Tensor):
        return depth.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.asarray(depth, np.float64)).to(device)


def depth_to_normal64(
    depth, fx: float, fy: float, cx: float, cy: float, version: Version = "v3", device="cuda",
) -> torch.Tensor:
    """[H, W] depth (numpy or tensor) -> [H, W, 3] float64 unit normals on
    `device`, camera-facing (the reference's convention: flipped at the end)."""
    z = _depth(depth, device)
    h, w = z.shape
    # 1-indexed pixel frames, matching the reference's arange(1, n+1)
    u = torch.arange(1, w + 1, dtype=torch.float64, device=z.device)[None, :] - cx
    v = torch.arange(1, h + 1, dtype=torch.float64, device=z.device)[:, None] - cy

    if version == "basic":
        gu, gv = central_gradients(z)
    elif version in ("v2", "v3"):
        gu, gv = dag_gradients(z)
    else:
        raise ValueError(f"unknown D2NT version {version!r} (basic, v2, v3)")

    nx = gu * fx
    ny = gv * fy
    nz = -(z + v * gv + u * gu)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)[..., None]
    n = torch.stack([nx, ny, nz], dim=-1) / (norm + 1e-12)

    if version == "v3":
        n = mrf_refine(z, n)
    return -n


def depth_to_normal(
    depth, fx: float, fy: float, cx: float, cy: float, version: Version = "v3", device="cuda",
) -> torch.Tensor:
    """`depth_to_normal64` cast to float32, as the JAX tool returns it."""
    return depth_to_normal64(depth, fx, fy, cx, cy, version, device).float()


def _laplacians(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lap_hor = torch.abs(_shift(z, 0, -1) + _shift(z, 0, 1) - 2 * z)
    lap_ver = torch.abs(_shift(z, -1, 0) + _shift(z, 1, 0) - 2 * z)
    return lap_hor, lap_ver


def mrf_choice(depth: torch.Tensor) -> torch.Tensor:
    """[H, W] int64 index of the MRF candidate each pixel takes: 0-3 the
    {left, right, up, down} neighbor whose depth Laplacian is smallest (inf
    out of frame), 4 the pixel itself (the mean of its two 1-D Laplacians);
    of equal costs the first."""
    lap_hor, lap_ver = _laplacians(depth)
    cost = torch.stack(
        [_fill_shift(lap_hor if dy == 0 else lap_ver, dy, dx, float("inf")) for dy, dx in MRF_CANDIDATES]
        + [(lap_hor + lap_ver) / 2.0]
    )
    index = torch.arange(len(cost), device=cost.device)[:, None, None]
    return torch.where(cost == cost.amin(dim=0), index, len(cost)).amin(dim=0)


def mrf_refine(depth: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Replace each pixel's normal with the {left,right,up,down,self} candidate whose
    depth Laplacian is smallest (self uses the mean of its two 1-D Laplacians;
    borders exclude out-of-frame neighbors)."""
    best = mrf_choice(depth)
    candidates = torch.stack([_fill_shift(normal, dy, dx, 0.0) for dy, dx in MRF_CANDIDATES] + [normal])
    return torch.gather(candidates, 0, best[None, ..., None].expand(1, *normal.shape))[0]


def normal_to_uint16(normal) -> np.ndarray:
    """[-1, 1] normals -> the 16-bit payload `(n + 1) * 32767.5`, truncated
    (float32 arithmetic for float32 normals, as the JAX tool's numpy)."""
    n16 = ((torch.as_tensor(normal) + 1.0) * 32767.5).to(torch.int32)
    return n16.cpu().numpy().astype(np.uint16)


def save_normal_png16(path: str, normal) -> None:
    """Save [-1, 1] normals as a 16-bit RGB png (the reference's storage format)."""
    image_io.write_png(path, normal_to_uint16(normal))


def load_normal_png16(path: str) -> np.ndarray:
    return image_io.read_image(path).astype(np.float32) / 32767.5 - 1.0


def vkitti_frames(root_dir: str):
    """(depth png, normal png it becomes) of every frame of the VKITTI depth
    tree, in the JAX tool's walk order."""
    depth_root = os.path.join(root_dir, "vkitti_2.0.3_depth")
    out_root = os.path.join(root_dir, "vkitti_DAG_normals")
    for dirpath, _, files in os.walk(depth_root):
        for fname in sorted(files):
            if not (fname.startswith("depth") and fname.endswith(".png")):
                continue
            out_dir = dirpath.replace(depth_root, out_root).replace(
                os.sep + "depth" + os.sep, os.sep + "normal" + os.sep
            )
            yield os.path.join(dirpath, fname), os.path.join(out_dir, fname.replace("depth", "normal"))


def generate_vkitti_normals(root_dir: str, version: Version = "v3", device="cuda", progress: bool = True) -> int:
    """Walk the VKITTI depth tree and write `vkitti_DAG_normals/.../normal_*.png`
    next to it; returns the number of frames processed."""
    fx, fy, cx, cy = VKITTI_INTRINSICS
    count = 0
    for depth_path, out_path in vkitti_frames(root_dir):
        depth_cm = image_io.read_image(depth_path)
        # the reference loads cm->m then multiplies back by 100: math runs in cm
        normal = depth_to_normal(depth_cm, fx, fy, cx, cy, version, device)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        save_normal_png16(out_path, normal)
        count += 1
        if progress and count % 200 == 0:
            print(f"[d2n] {count} frames", flush=True)
    return count
