"""The numbers that decide `correct`, each compared with the cell's limit.

Serving (per sampled request, the worst over the sample):
- `depth_mae`: the mean absolute gap between the program's depth in [0, 1]
  and the reference's;
- `normal_median_deg`, `normal_deg`: the median and the mean angle between
  the program's unit normals and the reference's, in degrees. A cell
  compares only the numbers its limits name: the fp8 control reads the
  angles under three times what sound runs of the program read (pixels
  whose decoded vector is short turn far on rounding), so no limit on them
  separates the two (PERF.md, "Limits").

Training (the micro-steps before the window, which the reference follows):
- `loss_gap`: the largest |loss - reference loss| / |reference loss| of the steps;
- `grad_median_gap`: of the leaves' gaps |norm of the program's first
  gradient (the optimizer's accumulator after one step) - the reference's|
  over the larger of that leaf's reference norm and the median leaf's, the
  median. The worst leaf's (`grad_worst_gap`, reported, not compared) is an
  output bias whose gradient is a sum over every pixel that nearly cancels,
  and swings from seed to seed in bfloat16 (PERF.md, "Limits");
- `update_gap`: the same of the parameters' change over the first optimizer
  step, over the leaves whose accumulated reference gradient is at least a
  thousandth of the median leaf's (the others move under Adam by rounding).

A number that is not finite, or an output of the wrong shape, reads inf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

INF = float("inf")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else INF


def serve_numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    out = {}
    for key, r in ref.items():
        p = prog.get(key)
        if p is None or p.shape != r.shape:
            out.update({"depth_mae": INF} if key == "depth" else {"normal_deg": INF, "normal_median_deg": INF})
            continue
        p, r = p.astype(np.float64), r.astype(np.float64)
        if key == "depth":
            out["depth_mae"] = _finite(float(np.abs(p - r).mean()))
        else:
            dot = (p * r).sum(-1) / np.maximum(np.linalg.norm(p, axis=-1) * np.linalg.norm(r, axis=-1), 1e-12)
            angle = np.degrees(np.arccos(np.clip(dot, -1.0, 1.0)))
            out["normal_deg"] = _finite(float(angle.mean()))
            out["normal_median_deg"] = _finite(float(np.median(angle)))
    return out


def worst(readings: Sequence[Dict[str, float]]) -> Dict[str, float]:
    keys = {k for r in readings for k in r}
    return {k: max(r.get(k, INF) for r in readings) for k in sorted(keys)}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str], over=max) -> float:
    """`over` (the worst, or the median) of the leaves' gaps of norms, each over
    the larger of the leaf's reference norm and the median leaf's."""
    if not names:
        return INF
    floor = float(np.median([ref[n] for n in ref]))
    gaps = [abs(prog.get(n, INF) - ref[n]) / max(ref[n], floor, 1e-30) for n in names]
    return _finite(float(over(gaps)))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = max(losses) if len(losses) == len(ref["losses"]) else INF
    acc = ref["acc_norm"]
    floor = float(np.median(list(acc.values())))
    moving = [n for n in ref["dp"] if acc[n] >= 1e-3 * floor]
    return {"loss_gap": _finite(loss_gap), "grad_median_gap": leaf_gap(prog["g1"], ref["g1"], list(ref["g1"]), np.median),
            "grad_worst_gap": leaf_gap(prog["g1"], ref["g1"], list(ref["g1"])),
            "update_gap": leaf_gap(prog["dp"], ref["dp"], moving)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(k in numbers and numbers[k] <= limits[k] for k in limits)


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], n: int = 5) -> List[tuple]:
    """The n leaves with the widest gap of norms (for a look at what a reading is made of)."""
    floor = float(np.median(list(ref.values())))
    gaps = sorted(((abs(prog.get(k, INF) - v) / max(v, floor, 1e-30), k, prog.get(k), v) for k, v in ref.items()),
                  reverse=True)
    return gaps[:n]
