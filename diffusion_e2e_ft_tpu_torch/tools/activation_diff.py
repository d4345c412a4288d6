"""Layer-wise activation capture and diffing, port of
`diffusion_e2e_ft_tpu/tools/activation_diff.py`.

`capture_intermediates` runs a torch module with a forward hook on every
named submodule and returns each one's output, as flax's
`capture_intermediates` returns each submodule's `__call__` output; the
rest summarizes the captures (shape / mean / std / absmax) and diffs two
runs: ours against ours (a regression, an export round trip), or ours
against a dump of the JAX package (parity), with NCHW <-> NHWC
reconciliation in both directions (the port's maps are NCHW, the JAX
package's NHWC).

Dump format: a .npz of flattened path -> array. The port's paths are in the
HF dot dialect (`down_blocks.0.resnets.1`), the dump format the JAX tool's
`load_reference` receives; `canonicalize_path` maps both dialects onto one
key. A module called more than once gets one entry a call, and a module that
returns a tuple one entry an element, each under a further index segment
(`down_blocks.0/1/0`: the first down block's second output, its first
element), as flax stores its invocations. The JAX tool's canonical form glues
the first such index to the module name; here an index stays a segment of its
own, so tuple outputs meet flax's in one key.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def capture_intermediates(module: torch.nn.Module, *args, **kwargs):
    """Run `module(*args, **kwargs)` with every submodule's output captured;
    returns (output, {path: float32 numpy array}), the root module's output
    under ''."""
    calls: Dict[str, List[Any]] = {}
    hooks = []

    def record(name: str):
        def hook(_module, _inputs, output):
            calls.setdefault(name, []).append(_to_numpy(output))
        return hook

    for name, sub in module.named_modules():
        hooks.append(sub.register_forward_hook(record(name)))
    try:
        out = module(*args, **kwargs)
    finally:
        for h in hooks:
            h.remove()
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path: str, suffixes: tuple):
        if isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                # one entry per element; a single call or a 1-tuple adds no index, as in flax
                walk(v, path, suffixes + (() if len(node) == 1 else (str(i),)))
        elif node is not None:
            flat["/".join((path, *suffixes)) if suffixes else path] = node

    for name, outputs in calls.items():
        walk(outputs, name, ())
    return out, flat


def _to_numpy(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return [_to_numpy(v) for v in x]
    return None


def summarize(acts: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    out = {}
    for k, v in acts.items():
        v = np.asarray(v, np.float32)
        out[k] = {
            "shape": list(v.shape),
            "mean": float(v.mean()),
            "std": float(v.std()),
            "absmax": float(np.abs(v).max()),
        }
    return out


def canonicalize_path(path: str) -> str:
    """Map torch ('down_blocks.0.resnets.1', with call / tuple indices after
    a '/') and flax ('down_blocks_0/resnets_1') module paths onto one
    dialect: flax's, an index of a list of modules glued to its name."""
    module, sep, rest = path.partition("/")
    if "." in module:
        module = re.sub(r"\.(\d+)(?=\.|$)", r"_\1", module).replace(".", "/")
    return (module + sep + rest).strip("/")


def _reconcile_layout(a: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """`a` transposed to `ref`'s layout when a channels-first / channels-last
    transpose makes the shapes match (NCHW <-> NHWC, CHW <-> HWC)."""
    if a.shape == ref.shape:
        return a
    perms = {4: ((0, 2, 3, 1), (0, 3, 1, 2)), 3: ((1, 2, 0), (2, 0, 1))}.get(a.ndim, ())
    for perm in perms:
        if a.transpose(perm).shape == ref.shape:
            return a.transpose(perm)
    return a


def diff(
    ours: Dict[str, np.ndarray],
    reference: Dict[str, np.ndarray],
    rtol: float = 1e-4,
    atol: float = 1e-4,
) -> List[Dict[str, Any]]:
    """Per-layer comparison, ordered by descending max abs error. Layers present on
    only one side are reported with error=None."""
    ours_c = {canonicalize_path(k): v for k, v in ours.items()}
    ref_c = {canonicalize_path(k): v for k, v in reference.items()}
    rows: List[Dict[str, Any]] = []
    for key in sorted(set(ours_c) | set(ref_c)):
        a = ours_c.get(key)
        b = ref_c.get(key)
        if a is None or b is None:
            rows.append({"layer": key, "only_in": "reference" if a is None else "ours"})
            continue
        a = np.asarray(a, np.float32)
        b = _reconcile_layout(np.asarray(b, np.float32), a)
        if a.shape != b.shape:
            rows.append({"layer": key, "shape_ours": a.shape, "shape_ref": b.shape})
            continue
        err = np.abs(a - b)
        denom = np.maximum(np.abs(b), atol / max(rtol, 1e-30))
        rows.append(
            {
                "layer": key,
                "max_abs_err": float(err.max()),
                "mean_abs_err": float(err.mean()),
                "max_rel_err": float(np.divide(err, denom, out=np.zeros_like(err), where=denom > 0).max()),
                "within_tol": bool(np.allclose(a, b, rtol=rtol, atol=atol)),
            }
        )
    rows.sort(key=lambda r: -(r.get("max_abs_err") or float("inf")))
    return rows


def save_dump(path: str, acts: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **{canonicalize_path(k): v for k, v in acts.items()})


def load_dump(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_reference(path: str) -> Dict[str, np.ndarray]:
    """Load reference activations from a single .npz OR a DIRECTORY of recorded
    files: every `*.npy` contributes one layer (key = filename stem, the torch
    dot dialect is fine: `diff` canonicalizes), every `*.npz` is merged in
    wholesale. A directory of a capture on another host diffs here without a
    packaging step."""
    import os

    if not os.path.isdir(path):
        return load_dump(path)
    acts: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if name.endswith(".npy"):
            acts[name[: -len(".npy")]] = np.load(full)
        elif name.endswith(".npz"):
            acts.update(load_dump(full))
    if not acts:
        raise FileNotFoundError(f"no .npy/.npz activation files under {path}")
    return acts


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: diff our dump against a reference dump file or directory.

    Exit code 0 = all layers within tolerance and no structural mismatches."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ours", required=True, help=".npz dump from our side")
    ap.add_argument(
        "--reference", required=True,
        help=".npz file or directory of .npy/.npz recorded reference activations",
    )
    ap.add_argument("--rtol", type=float, default=1e-4)
    ap.add_argument("--atol", type=float, default=1e-4)
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--top", type=int, default=20, help="rows to print")
    args = ap.parse_args(argv)

    rows = diff(load_dump(args.ours), load_reference(args.reference),
                rtol=args.rtol, atol=args.atol)
    for r in rows[: args.top]:
        print(json.dumps(r, default=str))
    structural = [r for r in rows if "max_abs_err" not in r]
    worst = max((r["max_abs_err"] for r in rows if "max_abs_err" in r), default=0.0)
    div = first_divergence(rows, args.threshold)
    print(
        f"layers={len(rows)} structural_mismatches={len(structural)} "
        f"worst_abs_err={worst:.3e} first_divergence={div}"
    )
    return 1 if (structural or div is not None) else 0


def first_divergence(
    rows: List[Dict[str, Any]], threshold: float = 1e-3
) -> Optional[str]:
    """The shallowest layer whose error exceeds threshold (depth ~ path length):
    where to start debugging."""
    bad = [r for r in rows if r.get("max_abs_err", 0.0) and r["max_abs_err"] > threshold]
    if not bad:
        return None
    bad.sort(key=lambda r: (r["layer"].count("/"), len(r["layer"])))
    return bad[0]["layer"]


if __name__ == "__main__":
    raise SystemExit(main())
