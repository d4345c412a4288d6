"""Hypersim preprocessing: HDR tone mapping and distance -> planar depth, port
of `diffusion_e2e_ft_tpu/tools/hypersim_preprocess.py` in torch on a device
(default the card).

As Marigold's `script/dataset_preprocess/hypersim/` (`hypersim_util.py:9-70`,
`preprocess_hypersim.py:21-153`): HDF5 frames are tone-mapped (scale chosen so
the 90th-percentile CCIR601 brightness maps to 0.8 after gamma 1/2.2),
distance-to-camera-center is converted to planar depth via the per-pixel ray
norm, and frames are exported as RGB png + uint16 mm depth png with a
per-split CSV row each.

The reader (`read_scene_hdf5`, h5py, imported lazily) and the preprocessing
(`preprocess_scene_frames`, arrays in, PNGs and rows out) are apart, so that
arrays from anywhere go the same way. PNGs are written through
`data/image_io.py`: the depth PNG is 16-bit grey, the values the JAX tool's
PIL `mode="I"` file holds (PIL saturates at 65535, as `depth_to_uint16_mm`
clips).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.data import image_io

HYPERSIM_FOCAL = 886.81
TONE_GAMMA = 1.0 / 2.2
TONE_PERCENTILE = 90
TONE_TARGET = 0.8
CSV_COLUMNS = ("rgb_path", "depth_path", "scene_name", "camera_name", "frame_id",
               "included_in_public_release", "split_partition_name")


def tone_map(rgb_hdr, valid_mask=None, device="cuda") -> torch.Tensor:
    """Scale so the 90th-percentile brightness hits 0.8 post-gamma; clip to
    [0, 1]. float64 math, a float32 [H, W, 3] result on `device`."""
    rgb = torch.as_tensor(rgb_hdr).to(device=device, dtype=torch.float64)
    valid = (torch.ones(rgb.shape[:2], dtype=torch.bool, device=rgb.device) if valid_mask is None
             else torch.as_tensor(valid_mask).to(device=rgb.device, dtype=torch.bool))
    brightness = 0.3 * rgb[..., 0] + 0.59 * rgb[..., 1] + 0.11 * rgb[..., 2]
    selected = brightness[valid]
    if selected.numel() == 0:
        scale = 1.0
    else:
        current = float(torch.quantile(selected, TONE_PERCENTILE / 100))
        scale = 0.0 if current < 1e-4 else np.power(TONE_TARGET, 1.0 / TONE_GAMMA) / current
    out = torch.pow(torch.clamp(scale * rgb, min=0.0), TONE_GAMMA)
    return torch.clamp(out, 0.0, 1.0).float()


def dist_to_depth(distance, focal: float = HYPERSIM_FOCAL, device="cuda") -> torch.Tensor:
    """Distance-to-camera-center -> planar depth: d * f / ||ray||, with image-plane
    rays through half-pixel-centered coordinates. float32, as the JAX tool's."""
    d = torch.as_tensor(distance).to(device=device, dtype=torch.float32)
    h, w = d.shape
    # the grid in float64, cast to float32 (np.linspace(..., dtype=float32)); half-integers, exact
    x = (torch.arange(w, dtype=torch.float64, device=d.device) - (0.5 * w - 0.5)).float()[None, :]
    y = (torch.arange(h, dtype=torch.float64, device=d.device) - (0.5 * h - 0.5)).float()[:, None]
    # numpy's float32 sqrt is correctly rounded, torch's CPU one is not: the square root in float64,
    # rounded once to float32, is the correctly rounded float32 root on either device
    ray_norm = torch.sqrt((x * x + y * y + focal**2).double()).float()
    return d / ray_norm * focal


def depth_to_uint16_mm(depth_m) -> torch.Tensor:
    """Meters -> millimeter uint16 png payload (the training storage format),
    as int32 on the input's device; NaN (no hit) becomes 0, as numpy's cast
    makes it."""
    mm = torch.as_tensor(depth_m).double() * 1000.0
    return torch.nan_to_num(mm, nan=0.0).clamp(0, 65535).to(torch.int32)


def preprocess_frame(rgb_hdr, distance, entity_id_map=None, device="cuda") -> Dict[str, np.ndarray]:
    """One frame: {"rgb": uint8 [H, W, 3], "depth_mm": uint16 [H, W],
    "depth_m": float32 [H, W]} on the host, computed on `device`."""
    valid = None if entity_id_map is None else torch.as_tensor(np.asarray(entity_id_map) != -1)
    rgb = (tone_map(rgb_hdr, valid, device) * 255).round().to(torch.uint8)
    depth = dist_to_depth(distance, device=device)
    mm = depth_to_uint16_mm(depth)
    return {"rgb": rgb.cpu().numpy(), "depth_mm": mm.cpu().numpy().astype(np.uint16), "depth_m": depth.cpu().numpy()}


Frame = Tuple[str, np.ndarray, np.ndarray, Optional[np.ndarray]]  # (frame id, rgb HDR, distance, entity ids)


def read_scene_hdf5(scene_dir: str, camera: str = "cam_00") -> Iterator[Frame]:
    """Every final_hdf5 color frame of one scene/camera, read lazily with h5py:
    (frame id, linear HDR rgb, distance in metres, render-entity ids or None)."""
    import h5py

    color_dir = os.path.join(scene_dir, "images", f"scene_{camera}_final_hdf5")
    geom_dir = os.path.join(scene_dir, "images", f"scene_{camera}_geometry_hdf5")
    if not os.path.isdir(color_dir):
        return
    for fname in sorted(os.listdir(color_dir)):
        if not fname.endswith(".color.hdf5"):
            continue
        frame = fname.split(".")[1]
        with h5py.File(os.path.join(color_dir, fname)) as f:
            rgb_hdr = np.asarray(f["dataset"], np.float32)
        with h5py.File(os.path.join(geom_dir, f"frame.{frame}.depth_meters.hdf5")) as f:
            distance = np.asarray(f["dataset"], np.float32)
        render_id_path = os.path.join(geom_dir, f"frame.{frame}.render_entity_id.hdf5")
        entity = None
        if os.path.exists(render_id_path):
            with h5py.File(render_id_path) as f:
                entity = np.asarray(f["dataset"])
        yield frame, rgb_hdr, distance, entity


def preprocess_scene_frames(
    frames: Iterable[Frame],
    out_dir: str,
    scene: str,
    camera: str = "cam_00",
    device="cuda",
    progress: bool = True,
) -> List[Dict[str, object]]:
    """Preprocess each frame into `out_dir/<scene>/{rgb,depth}/frame.<id>.png`;
    returns the CSV rows (rgb_path, depth_path, scene_name, camera_name,
    frame_id, included_in_public_release, split_partition_name)."""
    rows: List[Dict[str, object]] = []
    for frame, rgb_hdr, distance, entity in frames:
        out = preprocess_frame(rgb_hdr, distance, entity, device)
        rgb_rel = os.path.join(scene, "rgb", f"frame.{frame}.png")
        depth_rel = os.path.join(scene, "depth", f"frame.{frame}.png")
        for rel, array in ((rgb_rel, out["rgb"]), (depth_rel, out["depth_mm"])):
            os.makedirs(os.path.dirname(os.path.join(out_dir, rel)), exist_ok=True)
            image_io.write_png(os.path.join(out_dir, rel), array)
        rows.append(
            {
                "rgb_path": rgb_rel,
                "depth_path": depth_rel,
                "scene_name": scene,
                "camera_name": camera,
                "frame_id": int(frame),
                "included_in_public_release": True,
                "split_partition_name": "train",
            }
        )
        if progress and len(rows) % 50 == 0:
            print(f"[hypersim] {scene}/{camera}: {len(rows)} frames", flush=True)
    return rows


def preprocess_scene_hdf5(
    scene_dir: str, out_dir: str, camera: str = "cam_00", device="cuda", progress: bool = True,
) -> List[Dict[str, object]]:
    """`read_scene_hdf5` through `preprocess_scene_frames`: the JAX tool's
    `preprocess_scene_hdf5` on `device`."""
    scene = os.path.basename(os.path.normpath(scene_dir))
    return preprocess_scene_frames(read_scene_hdf5(scene_dir, camera), out_dir, scene, camera, device, progress)
