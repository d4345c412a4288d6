"""The caching allocator's device calls a request (`cudaMalloc`, `cudaFree`,
retries): the program's `allocs` counter on its `request` span. CUDA only."""

from lib.program import mean_counter

LAYER = "device"
SOURCE, UNIT, BETTER, MOVES = "program_span", "calls/req", "lower", "latency_p90_ms"


def read(rec):
    return mean_counter(rec, "allocs")
