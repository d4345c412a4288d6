"""Image/geometry augmentation library for normal-estimation training & eval.

The port's own copy of `diffusion_e2e_ft_tpu/data/augmentations.py` (host
numpy, cv2 imported lazily by the transforms that need it), so that one
Generator seed gives the JAX package's draws. As DSINE's
`data/augmentations/{__init__,basic,appearance,perspective}.py`: a
compositor over intrinsics-aware transforms: resize, random/NYU crops,
horizontal flip (normals + intrinsics corrected), photometric jitter,
blur/noise/jpeg degradation, and perspective warps (same-FOV rotation).
The benchmark path uses only ToFloat; training pipelines compose the rest.

All transforms take and return a `dict` sample with optional keys: img [H,W,3]
float01, normal [H,W,3] in [-1,1], normal_mask [H,W] bool, depth [H,W],
intrins [3,3]. Randomness comes from an explicit numpy Generator.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from diffusion_e2e_ft_tpu_torch.utils import geometry as G

Sample = Dict[str, np.ndarray]


class Compose:
    def __init__(self, transforms: Sequence[Callable[[Sample, np.random.Generator], Sample]]):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample, rng: Optional[np.random.Generator] = None) -> Sample:
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class ToFloat:
    """uint8 images -> float01 (the only transform the benchmark mode applies)."""

    def __call__(self, s: Sample, rng) -> Sample:
        img = s["img"]
        if img.dtype == np.uint8:
            s = dict(s)
            s["img"] = img.astype(np.float32) / 255.0
        return s


class Resize:
    """Bilinear image / nearest label resize with the intrinsics scaled to match."""

    def __init__(self, height: int, width: int):
        self.hw = (height, width)

    def __call__(self, s: Sample, rng) -> Sample:
        import cv2

        h, w = s["img"].shape[:2]
        nh, nw = self.hw
        out = dict(s)
        out["img"] = cv2.resize(s["img"], (nw, nh), interpolation=cv2.INTER_LINEAR)
        for k in ("normal", "depth"):
            if k in s and s[k] is not None:
                out[k] = cv2.resize(s[k], (nw, nh), interpolation=cv2.INTER_NEAREST)
        if s.get("normal_mask") is not None:
            out["normal_mask"] = (
                cv2.resize(s["normal_mask"].astype(np.uint8), (nw, nh), interpolation=cv2.INTER_NEAREST)
                .astype(bool)
            )
        if s.get("intrins") is not None:
            out["intrins"] = G.intrins_scale(s["intrins"], nw / w, nh / h)
        return out


class RandomCrop:
    def __init__(self, height: int, width: int):
        self.hw = (height, width)

    def __call__(self, s: Sample, rng) -> Sample:
        h, w = s["img"].shape[:2]
        ch, cw = self.hw
        top = int(rng.integers(0, max(h - ch, 0) + 1))
        left = int(rng.integers(0, max(w - cw, 0) + 1))
        return _crop(s, top, left, ch, cw)


class NyuCrop:
    """The NYU white-border crop: [45:471, 41:601] on 480x640 frames."""

    def __call__(self, s: Sample, rng) -> Sample:
        return _crop(s, 45, 41, 426, 560)


def _crop(s: Sample, top: int, left: int, h: int, w: int) -> Sample:
    out = dict(s)
    for k in ("img", "normal", "depth", "normal_mask"):
        if s.get(k) is not None:
            out[k] = s[k][top : top + h, left : left + w]
    if s.get("intrins") is not None:
        out["intrins"] = G.intrins_crop(s["intrins"], left, top)
    return out


class HorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, s: Sample, rng) -> Sample:
        if rng.random() >= self.p:
            return s
        out = dict(s)
        for k in ("img", "normal", "depth", "normal_mask"):
            if s.get(k) is not None:
                out[k] = s[k][:, ::-1].copy()
        if s.get("normal") is not None:
            out["normal"][..., 0] *= -1
        if s.get("intrins") is not None:
            K = np.array(s["intrins"], np.float64)
            K[0, 2] = s["img"].shape[1] - K[0, 2]
            out["intrins"] = K
        out["flipped"] = np.asarray(not bool(s.get("flipped", False)))
        return out


class ColorJitter:
    """Brightness / contrast / saturation / hue jitter on float01 images."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05, p=0.5):
        self.b, self.c, self.s, self.h, self.p = brightness, contrast, saturation, hue, p

    def __call__(self, s: Sample, rng) -> Sample:
        if rng.random() >= self.p:
            return s
        img = s["img"].astype(np.float32).copy()
        img *= 1.0 + rng.uniform(-self.b, self.b)  # brightness
        mean = img.mean()
        img = (img - mean) * (1.0 + rng.uniform(-self.c, self.c)) + mean  # contrast
        gray = img.mean(axis=-1, keepdims=True)
        img = gray + (img - gray) * (1.0 + rng.uniform(-self.s, self.s))  # saturation
        if self.h > 0:  # cheap hue roll in RGB space
            shift = rng.uniform(-self.h, self.h)
            img = img + shift * (np.roll(img, 1, axis=-1) - img)
        out = dict(s)
        out["img"] = np.clip(img, 0.0, 1.0)
        return out


class GaussianBlur:
    def __init__(self, sigma_range=(0.1, 2.0), p=0.3):
        self.sigma_range, self.p = sigma_range, p

    def __call__(self, s: Sample, rng) -> Sample:
        import cv2

        if rng.random() >= self.p:
            return s
        sigma = rng.uniform(*self.sigma_range)
        out = dict(s)
        out["img"] = cv2.GaussianBlur(s["img"], (0, 0), sigma)
        return out


class GaussianNoise:
    def __init__(self, sigma_range=(0.0, 0.04), p=0.3):
        self.sigma_range, self.p = sigma_range, p

    def __call__(self, s: Sample, rng) -> Sample:
        if rng.random() >= self.p:
            return s
        sigma = rng.uniform(*self.sigma_range)
        out = dict(s)
        out["img"] = np.clip(
            s["img"] + rng.normal(0, sigma, s["img"].shape).astype(np.float32), 0, 1
        )
        return out


class JpegCompression:
    def __init__(self, quality_range=(30, 95), p=0.3):
        self.quality_range, self.p = quality_range, p

    def __call__(self, s: Sample, rng) -> Sample:
        import cv2

        if rng.random() >= self.p:
            return s
        q = int(rng.integers(*self.quality_range))
        u8 = (s["img"] * 255).clip(0, 255).astype(np.uint8)
        ok, enc = cv2.imencode(".jpg", u8[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, q])
        out = dict(s)
        out["img"] = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32) / 255.0
        return out


class Normalize:
    """ImageNet-style channel normalization (DSINE's model-input convention)."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, s: Sample, rng) -> Sample:
        out = dict(s)
        out["img"] = (s["img"] - self.mean) / self.std
        return out


class RandomRotationWarp:
    """Same-FOV perspective warp by a random small camera rotation; normals are
    rotated into the new frame (DSINE's RotationAndScale)."""

    def __init__(self, max_deg: float = 10.0, p: float = 0.3):
        self.max_deg, self.p = max_deg, p

    def __call__(self, s: Sample, rng) -> Sample:
        if rng.random() >= self.p or s.get("intrins") is None:
            return s
        angles = rng.uniform(-self.max_deg, self.max_deg, 3)
        R = G.rotation_euler(*angles)
        K = s["intrins"]
        out = dict(s)
        out["img"] = G.homography_warp(s["img"], K, K, R)
        if s.get("normal") is not None:
            warped = G.homography_warp(s["normal"], K, K, R, nearest=True)
            out["normal"] = G.rotate_normals(warped, R)
        if s.get("normal_mask") is not None:
            out["normal_mask"] = G.homography_warp(
                s["normal_mask"].astype(np.uint8), K, K, R, nearest=True
            ).astype(bool)
        return out


def benchmark_transform() -> Compose:
    """The eval-mode pipeline: ToFloat only (dsine test path)."""
    return Compose([ToFloat()])


def training_transform(height: int, width: int) -> Compose:
    """A full training pipeline in the reference's composition order."""
    return Compose(
        [
            ToFloat(),
            Resize(height, width),
            HorizontalFlip(),
            ColorJitter(),
            GaussianBlur(),
            GaussianNoise(),
            JpegCompression(),
        ]
    )
