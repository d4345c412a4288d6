"""Depth evaluation dataset readers: NYUv2, KITTI, ETH3D, ScanNet, DIODE.

The port's copy of `diffusion_e2e_ft_tpu/data/depth_eval.py`: the same specs,
crops, masks and prediction names, reading images through `image_io` (PIL
and cv2 are not on the H100 host) and tars through the standard library's
`tarfile`. Images come straight out of a .tar archive (members named
`./<relative path>`) or a directory; depth is decoded per dataset convention
(16-bit PNG over a scale, `.npy`, or ETH3D's raw float32 binary); validity
masks combine the depth range with the dataset's benchmark crop.
Plain-python datasets yielding numpy dicts.
"""

from __future__ import annotations

import dataclasses
import io
import os
import tarfile
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffusion_e2e_ft_tpu_torch.data import image_io
from diffusion_e2e_ft_tpu_torch.data.splits import resolve_split_path


class DatasetMode(Enum):
    RGB_ONLY = "rgb_only"
    EVAL = "evaluate"
    TRAIN = "train"


class FileNameMode(Enum):
    """How a prediction file is named from the rgb basename."""

    id = 1  # pred_<basename>
    rgb_id = 2  # pred_<second _-token>
    i_d_rgb = 3  # replace _rgb. with _pred.
    rgb_i_d = 4  # pred_<tokens after first _>


def get_pred_name(rgb_basename: str, name_mode: FileNameMode, suffix: str = ".png") -> str:
    if name_mode == FileNameMode.rgb_id:
        stem = "pred_" + rgb_basename.split("_")[1]
    elif name_mode == FileNameMode.i_d_rgb:
        stem = rgb_basename.replace("_rgb.", "_pred.")
    elif name_mode == FileNameMode.id:
        stem = "pred_" + rgb_basename
    elif name_mode == FileNameMode.rgb_i_d:
        stem = "pred_" + "_".join(rgb_basename.split("_")[1:])
    else:
        raise NotImplementedError(name_mode)
    return os.path.splitext(stem)[0] + suffix


KB_CROP_HEIGHT, KB_CROP_WIDTH = 352, 1216


def kitti_benchmark_crop(img: np.ndarray) -> np.ndarray:
    """Bottom-centered 352x1216 crop (KITTI benchmark convention); HW or HWC."""
    h, w = img.shape[0], img.shape[1]
    top = int(h - KB_CROP_HEIGHT)
    left = int((w - KB_CROP_WIDTH) / 2)
    return img[top : top + KB_CROP_HEIGHT, left : left + KB_CROP_WIDTH, ...]


def _crop_mask(shape: Tuple[int, int], bounds: Tuple[float, float, float, float]) -> np.ndarray:
    """Rectangular eval mask from fractional (top, bottom, left, right) bounds."""
    h, w = shape
    t, b, l, r = bounds
    mask = np.zeros((h, w), bool)
    mask[int(t * h) : int(b * h), int(l * w) : int(r * w)] = True
    return mask


GARG_BOUNDS = (0.40810811, 0.99189189, 0.03594771, 0.96405229)
EIGEN_KITTI_BOUNDS = (0.3324324, 0.91351351, 0.0359477, 0.96405229)


@dataclasses.dataclass
class DepthEvalSpec:
    name: str
    min_depth: float
    max_depth: float
    name_mode: FileNameMode
    has_filled_depth: bool = False
    # decode a raw depth image array into meters
    depth_scale: float = 1.0
    # None | 'eigen_nyu' | 'garg' | 'eigen_kitti'
    eval_crop: Optional[str] = None
    kitti_bm_crop: bool = False
    # DIODE: third filename column is an npy validity mask
    mask_from_file: bool = False
    # ETH3D: raw float32 binary depth at fixed resolution
    raw_binary_hw: Optional[Tuple[int, int]] = None


SPECS: Dict[str, DepthEvalSpec] = {
    "nyu_v2": DepthEvalSpec(
        "nyu_v2", 1e-3, 10.0, FileNameMode.rgb_id, has_filled_depth=True,
        depth_scale=1000.0, eval_crop="eigen_nyu",
    ),
    "kitti": DepthEvalSpec(
        "kitti", 1e-5, 80.0, FileNameMode.id, depth_scale=256.0,
        eval_crop="eigen_kitti", kitti_bm_crop=True,
    ),
    "eth3d": DepthEvalSpec(
        "eth3d", 1e-5, np.inf, FileNameMode.id, raw_binary_hw=(4032, 6048)
    ),
    "scannet": DepthEvalSpec("scannet", 1e-3, 10.0, FileNameMode.id, depth_scale=1000.0),
    "diode": DepthEvalSpec("diode", 0.6, 350.0, FileNameMode.id, mask_from_file=True),
}

# NYU eigen crop in absolute pixels on the 480x640 frames
_NYU_EIGEN_CROP = (45, 471, 41, 601)


class DepthEvalDataset:
    """Iterable over samples: dicts with rgb_int [H,W,3] uint8, and in EVAL mode
    depth_raw_linear / depth_filled_linear [H,W] float32 + valid_mask_raw/filled."""

    def __init__(
        self,
        spec: DepthEvalSpec,
        dataset_path: str,  # directory or .tar file
        filename_list_path: str,
        mode: DatasetMode = DatasetMode.EVAL,
    ):
        self.spec = spec
        self.mode = mode
        self.dataset_path = dataset_path
        filename_list_path = resolve_split_path(filename_list_path)
        with open(filename_list_path) as f:
            self.filenames: List[List[str]] = [line.split() for line in f if line.strip()]
        if spec.name == "kitti":
            # drop frames without GT depth
            self.filenames = [f for f in self.filenames if f[1] != "None"]
        self._tar: Optional[tarfile.TarFile] = None
        self.is_tar = os.path.isfile(dataset_path) and tarfile.is_tarfile(dataset_path)
        self.decoder = image_io.png_decoder()  # "native_io" (libpng) or "numpy"

    # -- raw IO ---------------------------------------------------------

    def _read_bytes(self, rel_path: str) -> bytes:
        if self.is_tar:
            if self._tar is None:
                self._tar = tarfile.open(self.dataset_path)
            f = self._tar.extractfile("./" + rel_path)
            if f is None:
                raise FileNotFoundError(rel_path)
            return f.read()
        with open(os.path.join(self.dataset_path, rel_path), "rb") as f:
            return f.read()

    def _read_image(self, rel_path: str) -> np.ndarray:
        return image_io.decode_image(self._read_bytes(rel_path), self.decoder)

    def _read_depth(self, rel_path: str) -> np.ndarray:
        s = self.spec
        if s.raw_binary_hw is not None:
            depth = np.frombuffer(self._read_bytes(rel_path), dtype=np.float32).copy()
            depth[~np.isfinite(depth)] = 0.0
            return depth.reshape(s.raw_binary_hw)
        if rel_path.endswith(".npy"):
            return np.load(io.BytesIO(self._read_bytes(rel_path))).squeeze().astype(np.float32)
        return self._read_image(rel_path).squeeze().astype(np.float32) / s.depth_scale

    # -- masks ----------------------------------------------------------

    def _valid_mask(self, depth: np.ndarray) -> np.ndarray:
        s = self.spec
        mask = (depth > s.min_depth) & (depth < s.max_depth)
        if s.eval_crop == "eigen_nyu":
            t, b, l, r = _NYU_EIGEN_CROP
            crop = np.zeros_like(mask)
            crop[t:b, l:r] = True
            mask &= crop
        elif s.eval_crop == "garg":
            mask &= _crop_mask(mask.shape, GARG_BOUNDS)
        elif s.eval_crop == "eigen_kitti":
            mask &= _crop_mask(mask.shape, EIGEN_KITTI_BOUNDS)
        return mask

    # -- items ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        s = self.spec
        line = self.filenames[index]
        rgb_rel = line[0]

        rgb = self._read_image(rgb_rel)
        if s.kitti_bm_crop:
            rgb = kitti_benchmark_crop(rgb)
        out: Dict[str, np.ndarray] = {
            "rgb_int": rgb.astype(np.uint8),
            "index": index,
            "rgb_relative_path": rgb_rel,
        }
        if self.mode == DatasetMode.RGB_ONLY:
            return out

        depth_raw = self._read_depth(line[1])
        if s.kitti_bm_crop:
            depth_raw = kitti_benchmark_crop(depth_raw)
        if s.has_filled_depth and len(line) > 2 and not s.mask_from_file:
            depth_filled = self._read_depth(line[2])
            if s.kitti_bm_crop:
                depth_filled = kitti_benchmark_crop(depth_filled)
        else:
            depth_filled = depth_raw.copy()

        out["depth_raw_linear"] = depth_raw.astype(np.float32)
        out["depth_filled_linear"] = depth_filled.astype(np.float32)

        if s.mask_from_file:
            mask = (
                np.load(io.BytesIO(self._read_bytes(line[2]))).squeeze().astype(bool)
            )
            out["valid_mask_raw"] = mask
            out["valid_mask_filled"] = mask.copy()
        else:
            out["valid_mask_raw"] = self._valid_mask(depth_raw)
            out["valid_mask_filled"] = self._valid_mask(depth_filled)
        return out

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def pred_name(self, index: int, suffix: str = ".npy") -> str:
        base = os.path.basename(self.filenames[index][0])
        return get_pred_name(base, self.spec.name_mode, suffix)

    def __del__(self):
        if self._tar is not None:
            self._tar.close()


def get_depth_dataset(
    config: Dict,
    base_data_dir: str,
    mode: DatasetMode = DatasetMode.EVAL,
) -> DepthEvalDataset:
    """Build from a dataset-config dict (the reference's YAML fields: name, dir,
    filenames)."""
    name = config["name"]
    if name not in SPECS:
        raise ValueError(f"Unknown dataset: {name} (have {sorted(SPECS)})")
    return DepthEvalDataset(
        SPECS[name],
        os.path.join(base_data_dir, config["dir"]),
        config["filenames"],
        mode=mode,
    )
