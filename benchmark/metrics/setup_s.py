"""Seconds from the process's start to the window's start: imports, the
kernels' build on a checkout's first run, the weights made on the card, the
program's construction and the warm-up of the cell's shapes (serving) or the
checked first optimizer step (training)."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"


def read(rec):
    return rec["setup_s"]
