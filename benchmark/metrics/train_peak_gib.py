"""`torch.cuda.max_memory_allocated()` over the window (reset at its start),
in GiB: the trainer's resident state plus one micro-step's activations."""

SOURCE, UNIT, BETTER = "host_clock", "GiB", "lower"


def read(rec):
    return rec["peak_bytes"] / 2**30 if rec.get("images") and rec["peak_bytes"] > 0 else None
