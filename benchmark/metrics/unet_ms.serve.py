"""Device ms of the pipeline's UNet calls a request (CUDA events around each
call of the pipeline's `unet`), as a mean per request."""

LAYER = "models"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    n = len(rec.get("spans", {}).get("request", []))
    ms = rec.get("event_ms", {}).get("unet")
    return ms / n if n and ms else None
