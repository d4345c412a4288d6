"""Host ms of the program's `post` span a request: from the device body's
return to the answer (min-max normalisation, the resize back, the copies to
the host, numpy, GeoWizard's colour maps), not synchronised. A traced run's
synchronise after `infer` falls before the span opens, so it holds host work
and the waits of its own copies."""

from lib.program import mean_span_ms

LAYER = "request entry"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    return mean_span_ms(rec, ["post"])
