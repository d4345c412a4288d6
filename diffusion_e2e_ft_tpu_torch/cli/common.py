"""Shared CLI plumbing, port of `diffusion_e2e_ft_tpu/cli/common.py`:
argparse with @argfile support, image folder walking, dataset-config
loading and image files, with neither PyYAML nor PIL (the H100 host has
neither).

The dataset configs (`config/dataset/*.yaml`) are flat `key: value` maps;
`load_dataset_config` reads exactly that (strings, ints, floats, booleans,
null) and raises on anything nested.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from typing import Any, Dict, List

import numpy as np

from diffusion_e2e_ft_tpu_torch.data import image_io

EXTENSION_LIST = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff")

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?")
_BOOLS = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}


def make_parser(description: str) -> argparse.ArgumentParser:
    """Parser accepting `@args.txt` files with one `--flag value` pair per line
    (the DSINE convention)."""
    p = argparse.ArgumentParser(description=description, fromfile_prefix_chars="@")
    p.convert_arg_line_to_args = lambda line: line.split()
    return p


def add_device_argument(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", default="cuda", help=f"torch device of {what} (default cuda)")


def resolve_device(name: str):
    """The torch device `name`; raises where CUDA is asked for and torch sees none."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device (pass --device cpu)")
    return device


def list_images(input_dir: str) -> List[str]:
    files = []
    for f in sorted(glob.glob(os.path.join(input_dir, "*"))):
        if os.path.splitext(f)[1].lower() in EXTENSION_LIST:
            files.append(f)
    return files


def _scalar(text: str) -> Any:
    """A YAML 1.1 plain or quoted scalar, as `yaml.safe_load` reads the
    configs' values."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in _BOOLS:
        return _BOOLS[low]
    if low in ("null", "~"):
        return None
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text) and any(ch.isdigit() for ch in text):
        return float(text)
    if text[0] in "[{&*!|>%@`":
        raise ValueError(f"dataset config value {text!r}: only flat scalars are supported")
    return text


def load_dataset_config(path: str) -> Dict[str, Any]:
    """A flat `key: value` YAML file (the dataset configs) as a dict."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            text = line.split(" #")[0].rstrip() if not line.lstrip().startswith("#") else ""
            if not text.strip() or text.strip() == "---":
                continue
            if text[0] in " \t-":
                raise ValueError(f"{path}:{lineno}: nested YAML is not supported: {line.rstrip()!r}")
            key, sep, value = text.partition(":")
            if not sep or not key.strip():
                raise ValueError(f"{path}:{lineno}: expected `key: value`, got {line.rstrip()!r}")
            if value.strip() == "":
                # `key:` followed by an indented block is a nested map or list
                out[key.strip()] = None
                continue
            out[key.strip()] = _scalar(value.strip())
    return out


def load_image_rgb(path: str) -> np.ndarray:
    """An 8-bit image file as [H, W, 3] uint8 RGB (gray repeated, alpha dropped)."""
    img = image_io.read_image(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: {img.dtype} image; load_image_rgb reads 8-bit images")
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):  # gray, gray + alpha
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def save_image(path: str, array) -> None:
    """Write a uint8 / uint16 array as a PNG (the CLIs' only output format)."""
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: save_image writes PNG files only")
    image_io.write_png(path, np.asarray(array))
