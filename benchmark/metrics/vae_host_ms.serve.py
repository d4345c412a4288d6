"""Host ms of the program's `encode` and `decode` spans a request
(`AutoencoderKL.encode_mean` and `.decode`, not synchronised), beside the
device ms of the same calls in `vae_ms.serve`."""

from lib.program import mean_span_ms

LAYER = "host dispatch"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    return mean_span_ms(rec, ["encode", "decode"])
