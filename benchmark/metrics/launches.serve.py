"""CUDA kernels a request launches: every kernel in the traced window over
the requests completed in it (copies and sets not counted)."""

from lib.readers import kernel_count

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "kernels/req", "lower", "latency_p90_ms"


def read(rec):
    n = len(rec.get("spans", {}).get("request", []))
    return kernel_count(rec) / n if n and rec.get("ops") else None
