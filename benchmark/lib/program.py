"""The program's own spans of a traced window (`diffusion_e2e_ft_tpu_torch/
utils/trace.py`, recorded while the window's profiler runs), by request, for
the readers of `pre_ms.serve`, `post_ms.serve`, `*_host_ms.serve`,
`device_lag_ms.serve`, `syncs.serve` and `allocs.serve`.

A program without that recorder gives None, as does a window holding no
`request` span of the program: each reader then reports nothing."""

from __future__ import annotations

import collections
import importlib
from typing import List, Optional, Sequence

KEY = "program_requests"  # where `requests` keeps its answer in `rec`


def _read(rec: dict) -> Optional[List[dict]]:
    try:
        trace = importlib.import_module("diffusion_e2e_ft_tpu_torch.utils.trace")
    except ModuleNotFoundError:
        return None
    w0, w1 = rec.get("w0"), rec.get("w1")
    if w0 is None:
        return None
    by_request = collections.defaultdict(list)
    for s in trace.spans():
        if w0 <= s.t0_ns and s.t1_ns <= w1:
            by_request[s.request_id].append(s)
    out = []
    for spans in by_request.values():
        roots = [s for s in spans if s.name == "request" and s.parent_id is None]
        if roots:
            named = collections.defaultdict(list)
            for s in spans:
                named[s.name].append((s.t0_ns, s.t1_ns))
            out.append({"spans": named, "attrs": roots[0].attrs or {}})
    out.sort(key=lambda r: r["spans"]["request"][0])
    return out or None


def requests(rec: dict) -> Optional[List[dict]]:
    """The program's requests whose `request` span lies inside the traced
    window, in order: each {"spans": name -> [(t0_ns, t1_ns)], "attrs": the
    request span's counters}."""
    if KEY not in rec:
        rec[KEY] = _read(rec)
    return rec[KEY]


def mean_span_ms(rec: dict, names: Sequence[str]) -> Optional[float]:
    """Host ms of the spans named `names`, a request; None where no request has one."""
    reqs = requests(rec)
    if not reqs or not any(r["spans"].get(n) for r in reqs for n in names):
        return None
    total = sum(t1 - t0 for r in reqs for n in names for t0, t1 in r["spans"].get(n, ()))
    return total / len(reqs) / 1e6


def mean_counter(rec: dict, name: str) -> Optional[float]:
    """The request span's counter `name`, a request; None where no request has it."""
    values = [r["attrs"][name] for r in requests(rec) or () if name in r["attrs"]]
    return sum(values) / len(values) if values else None
