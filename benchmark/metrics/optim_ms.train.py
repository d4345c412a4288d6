"""Device ms of the optimizer a micro-step (`trainer.optimizer.update`: the
accumulation, and on every K-th micro-step the clip and AdamW), CUDA events
around each call, as a mean per micro-step."""

LAYER = "optimizer"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "train_img_s"


def read(rec):
    ms = rec.get("event_ms", {}).get("optimizer")
    return ms / rec["micro_steps"] if ms and rec.get("micro_steps") else None
