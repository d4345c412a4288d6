"""HF-layout weights: conversion to and from the JAX package's param trees, and
file reading without the `safetensors` package.

The conversion is the JAX package's generic rule (`diffusion_e2e_ft_tpu/models/
convert.py:62-116`) run in reverse: conv kernels HWIO -> OIHW, linear kernels
IO -> OI, `kernel`/`scale` -> `weight`, list indices `_N` -> `.N`. CLIP text
and vision towers additionally take the HF `<tower>.embeddings.` /
`<tower>.encoder.` nesting (`diffusion_e2e_ft_tpu/pipelines/loading.py::
_clip_params_to_state_dict`), with `visual_projection` at the top level.
Only numpy and the standard library here; `load_weights` returns torch tensors.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# containers whose flax names carry a flattened list index (`resnets_0`)
_LIST_CONTAINERS = (
    "resnets", "attentions", "down_blocks", "up_blocks", "downsamplers",
    "upsamplers", "transformer_blocks", "net", "to_out", "layers",
)

# weights in any float type; I64 for the `position_ids` buffer of CLIP checkpoints
_SAFETENSORS_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
}


# old diffusers VAE attention names -> modern to_q/to_k/to_v/to_out.0
_VAE_ATTN_ALIASES = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def canonicalize_keys(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Rename old-style VAE attention keys to the modern names."""
    return {
        ".".join(_VAE_ATTN_ALIASES.get(p, p) for p in k.split(".")): v
        for k, v in state_dict.items()
    }


def _flax_path_to_key(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"(.*?)_(\d+)", p)
        if m and m.group(1) in _LIST_CONTAINERS:
            parts.extend([m.group(1), m.group(2)])
        else:
            parts.append(p)
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _key_to_flax_path(key: str, ndim: int) -> Tuple[str, ...]:
    merged = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    if merged[-1] == "weight":
        merged[-1] = "kernel" if ndim >= 2 else "scale"
    return tuple(merged)


def _to_torch_value(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if leaf == "kernel" and value.ndim == 2:  # IO -> OI
        return np.transpose(value, (1, 0))
    return value


def _to_flax_value(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:  # OIHW -> HWIO
        return np.transpose(value, (2, 3, 1, 0))
    if leaf == "kernel" and value.ndim == 2:
        return np.transpose(value, (1, 0))
    return value


def _walk(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def flax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """UNet / VAE param tree (numpy leaves) -> HF-keyed state dict (numpy)."""
    return {
        _flax_path_to_key(path): np.ascontiguousarray(_to_torch_value(path[-1], value))
        for path, value in _walk(params)
    }


def state_dict_to_flax_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of `flax_params_to_state_dict`."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        value = np.asarray(value)
        path = _key_to_flax_path(key, value.ndim)
        _set_path(tree, path, _to_flax_value(path[-1], value))
    return tree


# CLIP embedding tables and vectors: under `<tower>.embeddings.` in HF keys
_CLIP_EMBEDDINGS = ("token_embedding", "position_embedding", "class_embedding", "patch_embedding")


def _clip_params_to_state_dict(params: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for path, value in _walk(params):
        if path[-1] == "embedding":  # nn.Embed table: no transpose, leaf `weight`
            key = f"{path[0]}.weight"
        else:
            key = _flax_path_to_key(path)
            value = np.ascontiguousarray(_to_torch_value(path[-1], value))
        if path[0] == "visual_projection":
            out[key] = value
        elif path[0] in _CLIP_EMBEDDINGS:
            out[f"{prefix}.embeddings.{key}"] = value
        elif key.startswith("layers."):
            out[f"{prefix}.encoder.{key}"] = value
        else:
            out[f"{prefix}.{key}"] = value
    return out


def _clip_state_dict_to_flax_params(state_dict: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        value = np.asarray(value)
        if "position_ids" in key:
            continue
        key = key.replace(f"{prefix}.", "").replace("embeddings.", "").replace("encoder.", "")
        if key.endswith(("token_embedding.weight", "position_embedding.weight")):
            _set_path(tree, (key.split(".")[0], "embedding"), value)
        elif key == "class_embedding":
            _set_path(tree, (key,), value)
        else:
            path = _key_to_flax_path(key, value.ndim)
            _set_path(tree, path, _to_flax_value(path[-1], value))
    return tree


def clip_text_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """CLIP text-tower param tree -> HF `CLIPTextModel` state dict (numpy)."""
    return _clip_params_to_state_dict(params, "text_model")


def clip_text_state_dict_to_flax_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of `clip_text_params_to_state_dict` (ignores `position_ids`)."""
    return _clip_state_dict_to_flax_params(state_dict, "text_model")


def clip_vision_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """CLIP vision-tower param tree -> HF `CLIPVisionModelWithProjection` state
    dict (numpy): the key layout of the JAX package's vision export
    (`diffusion_e2e_ft_tpu/pipelines/loading.py::_clip_params_to_state_dict`)."""
    return _clip_params_to_state_dict(params, "vision_model")


def clip_vision_state_dict_to_flax_params(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of `clip_vision_params_to_state_dict` (ignores `position_ids`)."""
    return _clip_state_dict_to_flax_params(state_dict, "vision_model")


def replace_conv_in(state_dict: Mapping[str, torch.Tensor], repeat: int = 2) -> Dict[str, torch.Tensor]:
    """Duplicate the UNet's conv_in input channels 4 -> 4 * repeat, dividing
    weight and bias by `repeat` (the reference's input surgery, as the JAX
    package's `replace_conv_in`). OIHW: channels are axis 1."""
    out = dict(state_dict)
    out["conv_in.weight"] = state_dict["conv_in.weight"].repeat(1, repeat, 1, 1) / repeat
    out["conv_in.bias"] = state_dict["conv_in.bias"] / repeat
    return out


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a `.safetensors` file: 8-byte little-endian header length, a JSON
    header of {name: {dtype, shape, data_offsets}}, then the raw tensor bytes."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    (n,) = np.frombuffer(bytes(data[:8]), "<u8")
    header = json.loads(bytes(data[8 : 8 + int(n)]))
    base = 8 + int(n)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name} spans {end - begin} bytes, expected {count * itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=count, offset=base + begin).reshape(shape)
    return out


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a `.safetensors` or torch `.bin` weights file into CPU tensors."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)
