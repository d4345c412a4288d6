"""What a traced run records: host spans, CUDA-event times and the device's
kernel intervals, on one clock.

- `Recorder.wrap` replaces a callable of the program (an instance attribute)
  by one that records a host span around the call (`time.time_ns`, the clock
  of the profiler's timestamps), and, where asked, CUDA events around it and
  a synchronise before and after (for a synchronised host time).
- `DeviceTrace` runs the PyTorch profiler with device activity only: no CPU
  ops, no shapes, no stacks. Its kernel, copy and set intervals carry
  `time.time_ns` timestamps, as the spans do.
- `union_ns` and `idle_gaps` work on those intervals.

The wrappers are installed only in a traced run: a run with `--trace 0`
calls the program untouched.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional, Tuple

import torch


class Recorder:
    def __init__(self, timed_device: bool):
        self.spans: Dict[str, List[Tuple[int, int]]] = collections.defaultdict(list)
        self._events: Dict[str, list] = collections.defaultdict(list)
        self.timed_device = timed_device
        self._restore: List[Tuple[object, str, object]] = []

    def span(self, name: str, t0: int, t1: int) -> None:
        self.spans[name].append((t0, t1))

    def wrap(self, owner, attr: str, name: str, events: bool = False, sync: bool = False) -> None:
        fn = getattr(owner, attr)
        had_own = attr in owner.__dict__
        self._restore.append((owner, attr, fn if had_own else None))
        spans, evs, timed = self.spans[name], self._events[name], self.timed_device and events
        sync = sync and self.timed_device

        def wrapped(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            if timed:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.time_ns()
            out = fn(*args, **kwargs)
            if timed:
                end.record()
                evs.append((start, end))
            if sync:
                torch.cuda.synchronize()
            spans.append((t0, time.time_ns()))
            return out

        owner.__dict__[attr] = wrapped  # the instance's attribute shadows the class's method

    def unwrap(self) -> None:
        for owner, attr, fn in reversed(self._restore):
            if fn is None:
                owner.__dict__.pop(attr, None)
            else:
                owner.__dict__[attr] = fn
        self._restore.clear()

    def event_ms(self) -> Dict[str, float]:
        """Total device ms between each wrapped call's events (after a synchronise)."""
        if not self.timed_device:
            return {}
        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in evs) for n, evs in self._events.items() if evs}


class DeviceTrace:
    """The profiler over the device alone; `ops` after `stop`: (name, start_ns, dur_ns).
    On the CPU (the tests) the CPU's operators stand for the device's."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._prof = None
        self.ops: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        self._prof = torch.autograd.profiler.profile(
            use_device="cuda" if self._cuda else None, use_cpu=not self._cuda, use_kineto=True)
        self._prof.__enter__()

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)
        kind = torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU
        ops = []
        for e in self._prof.kineto_results.events():
            if e.device_type() == kind and e.duration_ns() > 0:
                ops.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self._prof = None


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union_ns(intervals: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The gaps in [lo, hi) that no interval covers, longest first."""
    gaps, cursor = [], lo
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    gaps = [(a, b) for a, b in gaps if b > a]
    return sorted(gaps, key=lambda g: g[0] - g[1])


class SpanIndex:
    """Finds the innermost harness span at a time."""

    def __init__(self, spans: Dict[str, List[Tuple[int, int]]]):
        self.spans = {n: sorted(ivs) for n, ivs in spans.items() if ivs}
        self.starts = {n: [s for s, _ in ivs] for n, ivs in self.spans.items()}

    def innermost(self, t: int) -> Optional[str]:
        """The shortest recorded span that holds time t, or None."""
        best, best_len = None, None
        for name, ivs in self.spans.items():
            i = bisect.bisect_right(self.starts[name], t) - 1
            if i >= 0 and ivs[i][1] >= t and (best_len is None or ivs[i][1] - ivs[i][0] < best_len):
                best, best_len = name, ivs[i][1] - ivs[i][0]
        return best


def window_ops(rec: dict) -> List[Tuple[str, int, int]]:
    """The device operations that overlap the traced window."""
    return [o for o in rec.get("ops", []) if o[1] + o[2] > rec["w0"] and o[1] < rec["w1"]]


def busy_ns(rec: dict) -> int:
    """Time in the traced window in which some operation ran on the device."""
    return union_ns([(s, s + d) for _, s, d in window_ops(rec)], rec["w0"], rec["w1"])


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    idle time of the traced window summed by the innermost harness span the
    host was in at each gap's middle ("outside spans" where none)."""
    by_name = collections.Counter()
    for name, _, d in window_ops(rec):
        by_name[name[:160]] += d
    gaps, index = collections.Counter(), SpanIndex(rec["spans"])
    for a, b in idle_gaps([(s, s + d) for _, s, d in window_ops(rec)], rec["w0"], rec["w1"]):
        gaps[index.innermost((a + b) // 2) or "outside spans"] += b - a
    return {"device_ops": [[n, ns / 1e9] for n, ns in by_name.most_common(top)],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps.most_common(top)]}
