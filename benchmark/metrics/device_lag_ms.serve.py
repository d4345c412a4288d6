"""How far the device runs behind the host once a request's device body is
dispatched: the end of the last device operation that starts before the
request's `post` span minus the end of its last `infer` span (the program's
spans), at least 0, in ms a request. Near 0, the device waits on the host,
and every ms of host dispatch is on the request's critical path."""

import bisect

from lib.program import requests

LAYER = "device"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    reqs, ops = requests(rec), sorted(rec.get("ops") or (), key=lambda o: o[1])
    if not reqs or not ops:
        return None
    starts, ends, last = [s for _, s, _ in ops], [], 0
    for _, s, d in ops:  # ends[i]: the latest end of ops[0..i]
        last = max(last, s + d)
        ends.append(last)
    lags = []
    for r in reqs:
        infer, post = r["spans"].get("infer"), r["spans"].get("post")
        if infer and post:
            i = bisect.bisect_left(starts, min(t0 for t0, _ in post))
            if i:
                lags.append(max(0, ends[i - 1] - max(t1 for _, t1 in infer)))
    return sum(lags) / len(lags) / 1e6 if lags else None
