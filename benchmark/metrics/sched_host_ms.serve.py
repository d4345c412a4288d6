"""Host ms of the program's `scheduler` spans a request (each denoising
step's update after its UNet call in `MarigoldPipeline.infer`), less each
span's wait for the device: the time from the span's opening to the end of
the first copy between host and card that starts inside it is left out (a
scalar made on the card or read from it: the host waits there until the
device has run the UNet call queued before the copy). What stays is the
update's Python, its later scalar round trips and its dispatch. A span with
no such copy counts whole. Nothing for a program without the span."""

import bisect

from lib.program import requests

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")


def read(rec):
    reqs = requests(rec)
    if not reqs or not any(r["spans"].get("scheduler") for r in reqs):
        return None
    copies = sorted((s, s + d) for name, s, d in rec.get("ops") or () if name.startswith(HOST_COPIES))
    starts = [s for s, _ in copies]
    total = 0
    for r in reqs:
        for t0, t1 in r["spans"].get("scheduler", ()):
            i = bisect.bisect_left(starts, t0)
            waited = copies[i][1] if i < len(copies) and copies[i][0] < t1 else t0
            total += t1 - min(max(t0, waited), t1)
    return total / len(reqs) / 1e6
