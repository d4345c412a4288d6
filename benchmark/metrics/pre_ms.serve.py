"""Host ms of the program's `pre` span a request: from `__call__`'s start to
its device body (numpy to tensor, the copy to the card, `resize_max_res`,
`normalize_rgb`, the member draws), not synchronised."""

from lib.program import mean_span_ms

LAYER = "request entry"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    return mean_span_ms(rec, ["pre"])
