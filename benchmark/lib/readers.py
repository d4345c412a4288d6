"""Helpers of the metric readers (`benchmark/metrics/*.py`): device time of
kernels matched by name, counts per request or step, and the reference's
work over the traced window."""

from __future__ import annotations

from typing import Optional, Sequence

from lib.trace import busy_ns, is_kernel, window_ops
from work import roofline as R


def matched_s(rec: dict, include: Sequence[str], exclude: Sequence[str] = ()) -> float:
    """Seconds of device operations in the traced window whose name holds one
    of `include` and none of `exclude` (case-insensitive)."""
    inc, exc = [s.lower() for s in include], [s.lower() for s in exclude]
    total = 0
    for name, _, d in window_ops(rec):
        low = name.lower()
        if any(s in low for s in inc) and not any(s in low for s in exc):
            total += d
    return total / 1e9


def kernel_count(rec: dict) -> int:
    return sum(1 for name, _, _ in window_ops(rec) if is_kernel(name))


def window_s(rec: dict) -> float:
    return (rec["w1"] - rec["w0"]) / 1e9


def idle_percent(rec: dict) -> Optional[float]:
    if "ops" not in rec or not rec["ops"]:
        return None
    return 100.0 * (1.0 - busy_ns(rec) / (rec["w1"] - rec["w0"]))


def share(bound_s: float, time_s: float) -> Optional[float]:
    """A share of the roofline in %, or None where no matched kernel ran."""
    return 100.0 * bound_s / time_s if time_s > 0 and bound_s > 0 else None


def per_request_work(rec: dict):
    """(work of each traced request, in order)."""
    return [rec["work"][hw] for hw in rec["processing"]]


def serve_flops(rec: dict) -> float:
    return sum(w.flops for w in per_request_work(rec))


def span_total_s(rec: dict, name: str) -> float:
    return sum(b - a for a, b in rec.get("spans", {}).get(name, [])) / 1e9


def mfu(flops: float, rec: dict) -> Optional[float]:
    return 100.0 * flops / (window_s(rec) * R.PEAK_BF16_FLOPS) if flops > 0 else None
