"""Regenerate evaluation split filename lists from the dataset archives, a copy of
`diffusion_e2e_ft_tpu/tools/make_splits.py`.

The reference ships ~76k-line txt filename lists (`Marigold/data_split/**`). Rather
than vendoring those data files, this tool reconstructs them from the dataset
archives themselves: it walks a tar (or directory), pairs rgb members with their
depth (and mask) members by the per-dataset naming convention, and writes the split
list the eval datasets consume. For exact parity with the published split
membership, pass `--subset` with an official id list.
"""

from __future__ import annotations

import os
import re
import tarfile
from typing import List, Optional

# per-dataset (rgb_pattern, rgb->depth substitution[, rgb->mask substitution])
PAIRING = {
    "nyu_v2": (r".*rgb_\d+\.png$", ("rgb_", "depth_"), ("rgb_", "filled_")),
    "kitti": (r".*/image_02/.*\.png$", ("image_02", "proj_depth/groundtruth/image_02"), None),
    "eth3d": (r".*\.(png|jpg|JPG)$", (".png", ".bin"), None),
    "scannet": (r".*color/\d+\.(jpg|png)$", ("color", "depth"), None),
    "diode": (r".*\.png$", (".png", "_depth.npy"), (".png", "_depth_mask.npy")),
}


def list_members(dataset_path: str) -> List[str]:
    if os.path.isfile(dataset_path) and tarfile.is_tarfile(dataset_path):
        with tarfile.open(dataset_path) as tar:
            return [m.name.lstrip("./") for m in tar.getmembers() if m.isfile()]
    out = []
    for dirpath, _, files in os.walk(dataset_path):
        for f in files:
            out.append(os.path.relpath(os.path.join(dirpath, f), dataset_path))
    return out


def build_split(
    dataset_name: str,
    dataset_path: str,
    subset: Optional[List[str]] = None,
) -> List[str]:
    """Lines of '<rgb> <depth>[ <mask_or_filled>]' for members present in the
    archive; `subset` filters rgb paths (exact match) to an official split."""
    if dataset_name not in PAIRING:
        raise ValueError(f"no pairing rule for {dataset_name}")
    pattern, depth_sub, extra_sub = PAIRING[dataset_name]
    members = set(list_members(dataset_path))
    rgb_re = re.compile(pattern)
    lines = []
    for m in sorted(members):
        if not rgb_re.match(m):
            continue
        if subset is not None and m not in subset:
            continue
        depth = m.replace(*depth_sub)
        if depth == m or depth not in members:
            continue
        parts = [m, depth]
        if extra_sub is not None:
            extra = m.replace(*extra_sub)
            if extra in members:
                parts.append(extra)
        lines.append(" ".join(parts))
    return lines


def write_split(
    dataset_name: str,
    dataset_path: str,
    out_path: str,
    subset_path: Optional[str] = None,
) -> int:
    subset = None
    if subset_path:
        with open(subset_path) as f:
            subset = [line.split()[0] for line in f if line.strip()]
    lines = build_split(dataset_name, dataset_path, subset)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return len(lines)
