"""Device ms of the VAE a request: CUDA events around each `encode_mean` and
`decode` call of the pipeline's VAE, as a mean per request."""

LAYER = "models"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "requests_per_s"


def read(rec):
    n = len(rec.get("spans", {}).get("request", []))
    ev = rec.get("event_ms", {})
    ms = ev.get("encode", 0.0) + ev.get("decode", 0.0)
    return ms / n if n and ms else None
