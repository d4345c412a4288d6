"""Host ms of the program's `image_encoder` spans a request (the CLIP tower's
forward, not synchronised)."""

from lib.program import mean_span_ms

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    return mean_span_ms(rec, ["image_encoder"])
