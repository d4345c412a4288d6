"""Host ms of the program's `unet` spans a request (`UNet2DCondition.forward`,
not synchronised): what it takes the host to dispatch the UNet, beside the
device ms of the same calls in `unet_ms.serve`."""

from lib.program import mean_span_ms

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    return mean_span_ms(rec, ["unet"])
