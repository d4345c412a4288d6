"""Device-idle ms between a request's UNet calls, summed over the request:
for each pair of consecutive `unet` spans of the program, the time in which
no device operation runs from the end of the first span (its work is all
dispatched by then, so an idle device has finished it) to the start of the
first device operation that starts after the second span opens (the second
call's work, or work queued before it that the device had not reached).
The device waits there on the host's scheduler update and the next call's
dispatch; in a traced window that dispatch includes what the profiler adds
to a CUDA graph's launch (it records each kernel of the graph). Nothing
where the program's span buffer dropped spans (a request may then lack some
of its `unet` spans), for a program without the spans, or for single-step
requests."""

import bisect
import importlib

from lib.program import requests
from lib.trace import union_ns

LAYER = "device"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    reqs, ops = requests(rec), sorted(rec.get("ops") or (), key=lambda o: o[1])
    if not reqs or not ops or importlib.import_module("diffusion_e2e_ft_tpu_torch.utils.trace").dropped():
        return None
    starts = [s for _, s, _ in ops]
    longest = max(d for _, _, d in ops)
    gaps = []
    for r in reqs:
        unets = sorted(r["spans"].get("unet", ()))
        if len(unets) < 2:
            continue
        idle = 0
        for (_, lo), (t0, _) in zip(unets, unets[1:]):
            j = bisect.bisect_left(starts, t0)
            if j == len(starts):
                continue
            hi = starts[j]
            if hi > lo:  # the operations that may overlap [lo, hi): those starting in it or, at most `longest` before
                i = bisect.bisect_left(starts, lo - longest)
                covered = union_ns([(s, s + d) for _, s, d in ops[i:j]], lo, hi)
                idle += hi - lo - covered
        gaps.append(idle)
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
