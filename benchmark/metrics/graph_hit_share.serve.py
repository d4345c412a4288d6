"""Share of the graphed modules' calls (the UNet, the CLIP image tower) that
a CUDA graph's replay served: 100 x replays / (replays + misses), over the
traced requests, from the program's `graph_replays` and `graph_misses`
counters on its `request` span. A miss ran eagerly where a graph could
serve: a shape's first call, its capture, or a shape seen again after its
graph was evicted. CUDA only; nothing for a program without the counters."""

from lib.program import requests

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "program_counter", "%", "higher", "requests_per_s"


def read(rec):
    attrs = [r["attrs"] for r in requests(rec) or () if "graph_replays" in r["attrs"]]
    replays = sum(a["graph_replays"] for a in attrs)
    calls = replays + sum(a["graph_misses"] for a in attrs)
    return 100.0 * replays / calls if calls else None
