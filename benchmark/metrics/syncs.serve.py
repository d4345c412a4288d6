"""Host-device synchronisations a request: the program's `syncs` counter on
its `request` span (PyTorch's CUDA sync debug mode: copies between the card
and pageable host memory, `.item()`, stream synchronisations; the harness's
`torch.cuda.synchronize()` calls are not counted). CUDA only."""

from lib.program import mean_counter

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "program_span", "syncs/req", "lower", "latency_p90_ms"


def read(rec):
    return mean_counter(rec, "syncs")
