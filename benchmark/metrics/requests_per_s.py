"""Requests completed in the window over the window's seconds (the window
ends when the last request sent in it returns)."""

SOURCE, UNIT, BETTER = "host_clock", "req/s", "higher"


def read(rec):
    done = rec["attempted"] - rec["failed"]
    return done / rec["window_s"] if rec.get("latencies_s") else None
