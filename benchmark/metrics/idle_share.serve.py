"""Share of the traced window in which no operation ran on the device:
100 x (1 - union of the device intervals / the window)."""

from lib.readers import idle_percent

LAYER = "device"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "lower", "requests_per_s"


def read(rec):
    return idle_percent(rec)
