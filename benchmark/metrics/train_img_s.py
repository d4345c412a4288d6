"""Input images of every micro-step dispatched in the window over the time
from the window's start to the final synchronise."""

SOURCE, UNIT, BETTER = "host_clock", "img/s", "higher"


def read(rec):
    return rec["images"] / rec["window_s"] if rec.get("images") else None
