"""Device ms of `value_and_grad` (forward, loss and backward) a micro-step:
CUDA events around the trainer instance's method, as a mean per micro-step."""

LAYER = "trainer"
SOURCE, UNIT, BETTER, MOVES = "program_span", "ms", "lower", "train_img_s"


def read(rec):
    ms = rec.get("event_ms", {}).get("value_and_grad")
    return ms / rec["micro_steps"] if ms and rec.get("micro_steps") else None
