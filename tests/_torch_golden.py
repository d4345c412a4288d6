"""The golden outputs' weight rule and file format.

One copy serves three readers: `tests/golden/make_goldens.py` (which runs the
JAX package on the CPU and writes `tests/golden/<name>.npz`),
`tests/test_torch_golden.py` (the port on the CPU, without JAX) and
`chip_smoke.py`'s phase 20 (the port on the card), which loads this file by
its path. It imports numpy and torch only: never JAX, the JAX package or the
port.

The rule. A module's weights are an HF-layout state dict (torch layout:
OIHW convolutions, [out, in] linears). `golden_weights` draws them from
`np.random.default_rng(seed)` in sorted key order with
`standard_normal(shape, dtype=np.float32)`, then scales each tensor by its
kind: weights with ndim >= 2 by 1/sqrt(prod(shape[1:])) (lecun: the fan-in
of OIHW and [out, in]); embedding tables and CLIP's class embedding by
0.02; 1-d norm weights to 1 + 0.1 n; biases to 0.1 n. Those are the scales
of `tests/_torch_port.py::random_flax_params`, keyed by HF names, so both
packages fill their own modules from the same numbers.

A golden file holds `meta` (JSON: the configs, each weight part's seed and
{key: shape}, the image size, what was cut against the published config,
the share of depth pixels inside (0, 1)), `digest.<part>` ([N, 2] float64:
each tensor's sum and sum of squares, sorted key order), the inputs and the
outputs. NumPy does not promise `Generator` streams across versions, so a
reader checks the digest before it compares anything: another stream fails
as "weight stream differs", not as a numeric mismatch.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the digest of a tensor, recomputed from the same draws: fp64 sums in another order
DIGEST_RTOL = 1e-9
# goldens must keep at least this share of their depth pixels strictly inside (0, 1): with lecun-scaled
# weights a deep model's depth can saturate at the clip, which would leave nothing to compare
MIN_INSIDE = 0.5

_EMBEDDINGS = ("token_embedding.weight", "position_embedding.weight", "class_embedding")


def weight_kind(key: str, ndim: int) -> str:
    """'embedding', 'matrix' (ndim >= 2), 'bias' or 'norm' (a 1-d weight)."""
    if key.endswith(_EMBEDDINGS):
        return "embedding"
    if ndim >= 2:
        return "matrix"
    return "bias" if key.endswith("bias") else "norm"


def golden_weights(shapes: Mapping[str, Sequence[int]], seed: int) -> Dict[str, np.ndarray]:
    """{HF key: float32 array} for `shapes`, drawn by the rule from `seed`."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        shape = tuple(int(s) for s in shapes[key])
        n = rng.standard_normal(shape, dtype=np.float32)
        kind = weight_kind(key, len(shape))
        if kind == "embedding":
            n *= np.float32(0.02)
        elif kind == "matrix":
            n *= np.float32(1.0 / np.sqrt(np.prod(shape[1:])))
        elif kind == "norm":
            n = np.float32(1.0) + np.float32(0.1) * n
        else:
            n *= np.float32(0.1)
        out[key] = n
    return out


def digest(weights: Mapping[str, object]) -> np.ndarray:
    """[N, 2] float64: each tensor's sum and sum of squares, in sorted key
    order (numpy arrays or torch tensors, on any device)."""
    rows = []
    for key in sorted(weights):
        w = weights[key]
        if torch.is_tensor(w):
            w = w.detach().double()
            rows.append((float(w.sum()), float((w * w).sum())))
        else:
            w = np.asarray(w, np.float64)
            rows.append((float(w.sum()), float(np.square(w).sum())))
    return np.asarray(rows, np.float64).reshape(-1, 2)


def check_digest(name: str, part: str, got: np.ndarray, want: np.ndarray) -> None:
    """Raise 'weight stream differs' unless the digests agree to `DIGEST_RTOL`."""
    scale = np.maximum(np.abs(want), 1.0)
    bad = np.abs(got - want) > DIGEST_RTOL * scale
    if got.shape != want.shape or bad.any():
        raise AssertionError(
            f"{name}/{part}: weight stream differs from the one the golden was made with (numpy "
            f"{np.__version__}); {int(bad.sum()) if got.shape == want.shape else 'all'} of {len(want)} tensors' "
            "digests disagree, so the outputs cannot be compared")


def save_golden(path: str, meta: dict, digests: Mapping[str, np.ndarray], arrays: Mapping[str, np.ndarray]) -> None:
    out = {"meta": np.asarray(json.dumps(meta, sort_keys=True))}
    out.update({f"digest.{part}": np.asarray(d, np.float64) for part, d in digests.items()})
    out.update({k: np.asarray(v) for k, v in arrays.items()})
    np.savez_compressed(path, **out)


class Golden:
    """A golden file: `meta` (dict), `digests` ({part: [N, 2]}) and `arrays`."""

    def __init__(self, name: str, directory: str = GOLDEN_DIR):
        self.name = name
        with np.load(os.path.join(directory, f"{name}.npz"), allow_pickle=False) as z:
            self.meta = json.loads(str(z["meta"]))
            self.digests = {k.split(".", 1)[1]: z[k] for k in z.files if k.startswith("digest.")}
            self.arrays = {k: z[k] for k in z.files if k != "meta" and not k.startswith("digest.")}

    def __getitem__(self, key: str) -> np.ndarray:
        return self.arrays[key]

    def shapes(self, part: str) -> Dict[str, Tuple[int, ...]]:
        return {k: tuple(v) for k, v in self.meta["weights"][part]["shapes"].items()}

    def state_dict(self, part: str, device="cpu") -> Dict[str, torch.Tensor]:
        """The part's weights drawn by the rule, as torch tensors on `device`,
        checked against the file's digest there."""
        spec = self.meta["weights"][part]
        sd = {k: torch.from_numpy(v).to(device) for k, v in golden_weights(spec["shapes"], spec["seed"]).items()}
        check_digest(self.name, part, digest(sd), self.digests[part])
        return sd


def config(meta_config: Mapping[str, object]) -> dict:
    """A config's fields from `meta` with JSON lists back as tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in meta_config.items()}


def inside_share(depth: np.ndarray) -> float:
    """The share of depth values strictly inside (0, 1)."""
    d = np.asarray(depth)
    return float(((d > 0) & (d < 1)).mean())


def leaf_sum_bounds(count: np.ndarray, pmax: np.ndarray, element: np.ndarray) -> np.ndarray:
    """[N, 2] bounds on |d sum| and |d sum of squares| of leaves of `count`
    elements whose every element is within `element` of the reference's
    (pmax: each leaf's max |p|): count * e and count * e * (2 pmax + e), plus
    the fp64 sums' own rounding."""
    count, pmax, element = (np.asarray(a, np.float64) for a in (count, pmax, element))
    return np.stack([count * element, count * element * (2 * pmax + element)], axis=-1) + 1e-9
