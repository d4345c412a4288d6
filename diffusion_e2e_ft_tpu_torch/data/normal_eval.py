"""Surface-normal evaluation dataset readers (DSINE benchmark layout).

The port's copy of `diffusion_e2e_ft_tpu/data/normal_eval.py`. Shared
layout: each split line names `<scene>/<stem>_img.<ext>`; alongside it live
`<stem>_normal.png` (8-bit, or 16-bit for vkitti; valid where the pixel sum
> 0) or `<stem>_normal.exr` (float, valid where the vector norm > 0.5) and
`<stem>_intrins.npy`. Images and normal PNGs are read through `image_io`,
which gives RGB directly (the JAX reader swaps cv2's BGR); only the EXR
datasets (iBims, Sintel) need cv2, imported where they are read, and raise
naming it where it is missing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from diffusion_e2e_ft_tpu_torch.data import image_io
from diffusion_e2e_ft_tpu_torch.data.splits import dsine_split_path

# domain the GeoWizard pipeline should use per benchmark (as DSINE's test script assigns them)
GEOWIZARD_DOMAINS = {
    "nyuv2": "indoor",
    "scannet": "indoor",
    "ibims": "indoor",
    "sintel": "outdoor",
    "vkitti": "outdoor",
    "oasis": "object",
}

# normal GT storage format per benchmark
_EXR_DATASETS = {"ibims", "sintel"}
# vkitti stores 16-bit normal pngs (the D2NT output format); others are 8-bit
_PNG16_DATASETS = {"vkitti"}


def _read_exr_rgb(path: str) -> np.ndarray:
    """An OpenEXR normal map as float32 RGB, through cv2 (the one format
    `image_io` does not read)."""
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} (OpenEXR) needs cv2, which is not installed") from e
    bgr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if bgr is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB).astype(np.float32)


@dataclasses.dataclass
class NormalSample:
    img: np.ndarray  # [H, W, 3] float32 in [0, 1]
    normal: Optional[np.ndarray]  # [H, W, 3] float32 in [-1, 1]
    normal_mask: Optional[np.ndarray]  # [H, W] bool
    intrins: Optional[np.ndarray]  # [3, 3]
    dataset_name: str
    scene_name: str
    img_name: str


class NormalEvalDataset:
    """Iterates benchmark samples from a `dsine_eval/<name>` directory + split file."""

    def __init__(
        self,
        name: str,
        dataset_dir: str,  # .../dsine_eval/<name>
        split_path: Optional[str] = None,
        load_normal: bool = True,
        load_intrins: bool = True,
    ):
        self.name = name
        self.dataset_dir = dataset_dir
        self.load_normal = load_normal
        self.load_intrins = load_intrins
        # vendored curated split (data_split/dsine/<name>/split/*.txt) when present;
        # else a test.txt shipped next to the data
        split_path = dsine_split_path(name, split_path) or os.path.join(dataset_dir, "test.txt")
        with open(split_path) as f:
            self.sample_paths = [line.strip() for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.sample_paths)

    def __getitem__(self, index: int) -> NormalSample:
        rel = self.sample_paths[index]
        scene = rel.split("/")[0]
        stem, ext = rel.split("/")[1].split("_img")
        img_path = os.path.join(self.dataset_dir, rel)

        img = image_io.read_image(img_path).astype(np.float32) / 255.0

        normal = mask = None
        if self.load_normal:
            if self.name in _EXR_DATASETS:
                normal = _read_exr_rgb(img_path.replace("_img" + ext, "_normal.exr"))
                mask = np.linalg.norm(normal, axis=2) > 0.5
            else:
                raw = image_io.read_image(img_path.replace("_img" + ext, "_normal.png"))
                mask = np.sum(raw, axis=2) > 0
                denom = 65535.0 if self.name in _PNG16_DATASETS else 255.0
                normal = raw.astype(np.float32) / denom * 2.0 - 1.0

        intrins = None
        if self.load_intrins:
            intrins_path = img_path.replace("_img" + ext, "_intrins.npy")
            if os.path.exists(intrins_path):
                intrins = np.load(intrins_path)

        return NormalSample(
            img=img,
            normal=normal,
            normal_mask=mask,
            intrins=intrins,
            dataset_name=self.name,
            scene_name=scene,
            img_name=stem,
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def get_normal_dataset(
    name: str, base_data_dir: str, split_path: Optional[str] = None, **kw
) -> NormalEvalDataset:
    if name not in GEOWIZARD_DOMAINS:
        raise ValueError(f"Unknown normal benchmark: {name} (have {sorted(GEOWIZARD_DOMAINS)})")
    return NormalEvalDataset(
        name, os.path.join(base_data_dir, "dsine_eval", name), split_path, **kw
    )
