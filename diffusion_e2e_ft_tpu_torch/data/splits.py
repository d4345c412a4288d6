"""Vendored benchmark split lists and their resolution: the port's copy of
`diffusion_e2e_ft_tpu/data/splits.py` (both resolve the repo root's
`data_split/`, each from its own location).

The published metrics are defined over curated file memberships: Marigold's
`data_split/**` (NYU test 653, KITTI eigen 696, ETH3D 453, ScanNet 799, DIODE
770, Hypersim train 53,884, VKITTI 20,147) and DSINE's per-dataset split
txts, vendored verbatim under `<repo>/data_split/`.
"""

from __future__ import annotations

import os
from typing import Optional

# repo root = parent of the package directory (data_split/ lives next to the package)
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# canonical DSINE split file per benchmark dataset (DSINE's baseline_normal dataloader and dsine test script)
DSINE_SPLITS = {
    "nyuv2": "test.txt",
    "scannet": "test.txt",
    "ibims": "ibims.txt",
    "sintel": "sintel.txt",
    "oasis": "val.txt",
    "vkitti": "vkitti.txt",
}


def data_split_root() -> str:
    return os.path.join(_REPO_ROOT, "data_split")


def resolve_split_path(path: str) -> str:
    """Resolve a split-list path: absolute / CWD-relative as given, else relative to
    the repo root (where the vendored `data_split/` tree lives). This lets the
    dataset-config YAMLs keep the reference's relative `data_split/...` paths while
    working from any CWD."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    vendored = os.path.join(_REPO_ROOT, path)
    if os.path.exists(vendored):
        return vendored
    return path


def dsine_split_path(dataset_name: str, split_path: Optional[str] = None) -> Optional[str]:
    """The vendored DSINE split list for a benchmark dataset, or the explicit
    override. Returns None when neither exists (caller falls back to a local
    test.txt next to the data)."""
    if split_path is not None:
        return resolve_split_path(split_path)
    fname = DSINE_SPLITS.get(dataset_name)
    if fname is None:
        return None
    vendored = os.path.join(data_split_root(), "dsine", dataset_name, "split", fname)
    return vendored if os.path.exists(vendored) else None
