"""Training datasets: Hypersim and VirtualKITTI2, with the shared sample transform.

The port's own copy of `diffusion_e2e_ft_tpu/data/train_datasets.py` (numpy),
so the PyTorch package imports nothing of the JAX package. It reads what the
JAX readers read, with neither pandas nor cv2: the Hypersim CSV through the
`csv` module (cells typed by column as pandas' `read_csv` types them), the
16-bit PNGs (depth; VKITTI's normals) through `data/image_io.py`. PIL
(imported where a reader needs it) decodes the JPEGs and 8-bit PNGs and
resizes, as in the JAX readers. PIL opens a 16-bit RGB PNG as 8-bit RGB
holding each channel's high byte; the port's VKITTI reader takes that byte.

Capability parity: the reference's `training/dataloaders/load.py:67-376` — Hypersim
(CSV-driven pairs, mm->m, camera-orientation normal fixing via inverse-K reprojection,
resize to 480x640) and VirtualKITTI2 (scene/weather/camera walk, cm->m, KITTI
benchmark crop 352x1216); both share: h-flip with normal-x inversion, 2%/98% quantile
depth normalization to [-1,1] with invalid->far-plane, normals unit-normalized with
invalid->zero-vector, fixed-shape NHWC numpy outputs.

Host-side numpy by design: all randomness from a per-dataset Generator, so an epoch
is reproducible from a seed (the train step only ever sees fixed-shape arrays).
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffusion_e2e_ft_tpu_torch.data import image_io

HYPERSIM_INTRINSICS = (886.81, 886.81)  # fx, fy; principal point at W/2, H/2
HYPERSIM_HW = (480, 640)
VKITTI_SCENES = ("Scene01", "Scene02", "Scene06", "Scene18", "Scene20")
VKITTI_WEATHER = ("morning", "fog", "rain", "sunset", "overcast")
VKITTI_CAMERAS = ("Camera_0", "Camera_1")
KB_CROP_HW = (352, 1216)


_INT = re.compile(r"[-+]?[0-9]+")
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _typed_column(cells: List[str]) -> list:
    """One CSV column's cells typed as pandas' `read_csv` types a column: all
    booleans (True / TRUE / true, False / ...) -> bool, all integers -> int
    (float where a cell is empty), else strings; an empty cell is NaN."""
    filled = [c for c in cells if c != ""]
    if filled and all(c in _BOOLS for c in filled):
        return [_BOOLS[c] if c else math.nan for c in cells]
    if filled and all(_INT.fullmatch(c) for c in filled):
        kind = int if len(filled) == len(cells) else float
        return [kind(c) if c else math.nan for c in cells]
    return [c if c else math.nan for c in cells]


def read_csv_rows(path: str) -> List[Dict[str, object]]:
    """The rows of a CSV with a header line, as dicts of pandas-typed cells."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        records = [r for r in reader if r]
    columns = {name: _typed_column([r[i] if i < len(r) else "" for r in records]) for i, name in enumerate(header)}
    return [{name: columns[name][j] for name in header} for j in range(len(records))]


def read_rgb8(path: str) -> np.ndarray:
    """An RGB PNG as uint8 [H, W, 3], as PIL's `Image.open(path).convert("RGB")`
    gives it for an 8- or 16-bit RGB file: a 16-bit channel's high byte."""
    rgb = image_io.read_image(path)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"{path}: expected an RGB PNG, got shape {rgb.shape}")
    return (rgb >> 8).astype(np.uint8) if rgb.dtype == np.uint16 else rgb


def _resize_pil(arr: np.ndarray, hw: Tuple[int, int], nearest: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(arr)
    img = img.resize((hw[1], hw[0]), Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(img)


def kb_crop(arr: np.ndarray) -> np.ndarray:
    """Bottom-centered 352x1216 crop (HW or HWC)."""
    h, w = arr.shape[0], arr.shape[1]
    top = int(h - KB_CROP_HW[0])
    left = int((w - KB_CROP_HW[1]) / 2)
    return arr[top : top + KB_CROP_HW[0], left : left + KB_CROP_HW[1], ...]


def align_normals_to_camera(
    normal: np.ndarray, depth: np.ndarray, fx: float, fy: float, cx: float, cy: float
) -> np.ndarray:
    """Flip normals that point away from the camera (Hypersim's orientation is
    inconsistent): unproject each pixel with the inverse intrinsics, flip where
    normal . point > 0."""
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    px = (xs - cx) / fx * depth
    py = (ys - cy) / fy * depth
    points = np.stack([px, py, depth], axis=-1)
    flip = np.sum(normal * points, axis=-1) > 0
    out = normal.copy()
    out[flip] *= -1
    return out


def postprocess_sample(
    rgb01: np.ndarray,  # [H, W, 3] float in [0, 1]
    depth_m: np.ndarray,  # [H, W] metric depth
    normal: Optional[np.ndarray],  # [H, W, 3] in [-1, 1] or None
    near_plane: float,
    far_plane: float,
    domain: str,
) -> Dict[str, np.ndarray]:
    """The shared quantile normalization / masking / normal cleanup."""
    valid = (depth_m > near_plane) & (depth_m < far_plane)

    rgb = (rgb01 * 2.0 - 1.0).astype(np.float32)

    depth_m = depth_m.astype(np.float32)
    if valid.any():
        flat = depth_m[valid]
        lo, hi = np.quantile(flat, 0.02), np.quantile(flat, 0.98)
        if lo == hi:
            depth_norm = np.zeros_like(depth_m)
            metric = np.zeros_like(depth_m)
            valid = np.zeros_like(valid)
        else:
            clamped = np.clip(depth_m, lo, hi)
            clamped[~valid] = hi  # invalid -> relative far plane
            metric = clamped.copy()
            depth_norm = np.clip((clamped - lo) / (hi - lo) * 2.0 - 1.0, -1.0, 1.0)
    else:
        depth_norm = np.zeros_like(depth_m)
        metric = np.zeros_like(depth_m)

    out = {
        "rgb": rgb,
        "depth": depth_norm.astype(np.float32),  # [-1,1], for latent-space training
        "metric": metric.astype(np.float32),  # clamped metric depth, for SSI loss
        "val_mask": valid,
        "domain": domain,
    }
    if normal is not None:
        n = normal.astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        n[~valid] = 0.0  # invalid -> zero vector
        out["normals"] = n
    return out


def _hflip(rgb01, depth, normal):
    rgb01 = rgb01[:, ::-1].copy()
    depth = depth[:, ::-1].copy()
    if normal is not None:
        normal = normal[:, ::-1].copy()
        normal[..., 0] *= -1  # mirror the x component
    return rgb01, depth, normal


@dataclasses.dataclass
class HypersimSample:
    rgb_path: str
    depth_path: str
    normal_path: str


class Hypersim:
    """CSV-driven Hypersim pairs; yields fixed 480x640 samples, domain 'indoor'."""

    def __init__(
        self,
        root_dir: str,
        split_csv: Optional[str] = None,
        near_plane: float = 1e-5,
        far_plane: float = 65.0,
        flip_p: float = 0.5,
        align_cam_normal: bool = True,
        seed: int = 0,
    ):
        self.root_dir = root_dir
        self.near_plane = near_plane
        self.far_plane = far_plane
        self.flip_p = flip_p
        self.align_cam_normal = align_cam_normal
        self.rng = np.random.default_rng(seed)

        split_csv = split_csv or os.path.join(root_dir, "processed", "train", "filename_meta_train.csv")
        self.pairs: List[HypersimSample] = []
        for row in read_csv_rows(split_csv):
            if not (row.get("included_in_public_release", True) and row.get("split_partition_name", "train") == "train"):
                continue
            rgb = os.path.join(root_dir, "train", row["rgb_path"])
            depth = os.path.join(root_dir, "train", row["depth_path"])
            normal = os.path.join(
                os.path.dirname(os.path.join(root_dir, "train")),
                "normals",
                row["scene_name"],
                "images",
                f"scene_{row['camera_name']}_geometry_preview",
                f"frame.{str(row['frame_id']).zfill(4)}.normal_cam.png",
            )
            if os.path.exists(rgb) and os.path.exists(depth) and os.path.exists(normal):
                self.pairs.append(HypersimSample(rgb, depth, normal))

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        p = self.pairs[idx]
        rgb01 = np.asarray(Image.open(p.rgb_path).convert("RGB"), np.float32) / 255.0
        depth = image_io.read_image(p.depth_path).astype(np.float32) / 1000.0  # mm -> m
        normal01 = np.asarray(Image.open(p.normal_path).convert("RGB"), np.float32) / 255.0
        normal = normal01 * 2.0 - 1.0

        if self.align_cam_normal:
            h, w = normal.shape[:2]
            normal[..., 1:] *= -1
            fx, fy = HYPERSIM_INTRINSICS
            normal = align_normals_to_camera(normal, depth.astype(np.float64), fx, fy, w / 2, h / 2) * -1

        if self.rng.random() < self.flip_p:
            rgb01, depth, normal = _hflip(rgb01, depth, normal)

        # resize: rgb/normal bilinear, depth nearest
        rgb01 = _resize_pil((rgb01 * 255).astype(np.uint8), HYPERSIM_HW).astype(np.float32) / 255.0
        normal = _resize_pil(
            ((normal + 1) / 2 * 255).clip(0, 255).astype(np.uint8), HYPERSIM_HW
        ).astype(np.float32) / 255.0 * 2.0 - 1.0
        depth = _resize_pil(depth, HYPERSIM_HW, nearest=True)

        return postprocess_sample(rgb01, depth, normal, self.near_plane, self.far_plane, "indoor")

    def skip(self, n: int) -> None:
        """Advance the per-sample draws past `n` samples that are not read
        (another data-parallel rank reads them)."""
        self.rng.random(n)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class VirtualKITTI2:
    """Scene/weather/camera directory walk; yields 352x1216 samples, domain 'outdoor'."""

    def __init__(
        self,
        root_dir: str,
        near_plane: float = 1e-5,
        far_plane: float = 80.0,
        flip_p: float = 0.5,
        seed: int = 0,
    ):
        self.near_plane = near_plane
        self.far_plane = far_plane
        self.flip_p = flip_p
        self.rng = np.random.default_rng(seed)
        self.pairs: List[Tuple[str, str, str]] = []
        rgb_root = os.path.join(root_dir, "vkitti_2.0.3_rgb")
        depth_root = os.path.join(root_dir, "vkitti_2.0.3_depth")
        normal_root = os.path.join(root_dir, "vkitti_DAG_normals")
        for scene in VKITTI_SCENES:
            for weather in VKITTI_WEATHER:
                for cam in VKITTI_CAMERAS:
                    rgb_dir = os.path.join(rgb_root, scene, weather, "frames", "rgb", cam)
                    depth_dir = os.path.join(depth_root, scene, weather, "frames", "depth", cam)
                    normal_dir = os.path.join(normal_root, scene, weather, "frames", "normal", cam)
                    if not (os.path.isdir(rgb_dir) and os.path.isdir(depth_dir)):
                        continue
                    for f in sorted(os.listdir(rgb_dir)):
                        if not f.endswith(".jpg"):
                            continue
                        stem = f[3:]  # strip 'rgb'
                        self.pairs.append(
                            (
                                os.path.join(rgb_dir, "rgb" + stem),
                                os.path.join(depth_dir, "depth" + stem.replace(".jpg", ".png")),
                                os.path.join(normal_dir, "normal" + stem.replace(".jpg", ".png")),
                            )
                        )

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        rgb_path, depth_path, normal_path = self.pairs[idx]
        rgb01 = np.asarray(Image.open(rgb_path).convert("RGB"), np.float32) / 255.0
        depth = image_io.read_image(depth_path).astype(np.float32) / 100.0  # cm -> m
        normal = None
        if os.path.exists(normal_path):
            normal01 = read_rgb8(normal_path).astype(np.float32) / 255.0
            normal = normal01 * 2.0 - 1.0

        if self.rng.random() < self.flip_p:
            rgb01, depth, normal = _hflip(rgb01, depth, normal)

        rgb01 = kb_crop(rgb01)
        depth = kb_crop(depth)
        if normal is not None:
            normal = kb_crop(normal)

        return postprocess_sample(rgb01, depth, normal, self.near_plane, self.far_plane, "outdoor")

    def skip(self, n: int) -> None:
        """Advance the per-sample draws past `n` samples that are not read
        (another data-parallel rank reads them)."""
        self.rng.random(n)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
