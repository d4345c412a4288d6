"""Model FLOPs of the requests completed in the traced window (the
reference's products counted on the meta device at each request's
processing size) over the window times the H100's 989 TFLOP/s of bf16."""

from lib.readers import mfu, serve_flops

LAYER = "whole request"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "requests_per_s"


def read(rec):
    return mfu(serve_flops(rec), rec) if rec.get("ops") else None
