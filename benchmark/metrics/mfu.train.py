"""Model FLOPs of the micro-steps in the traced window (the reference's
forward and backward counted on the meta device, no recompute: the UNet
checkpoint's second forward is not counted) over the window times the
H100's 989 TFLOP/s of bf16."""

from lib.readers import mfu

LAYER = "whole step"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "train_img_s"


def read(rec):
    return mfu(rec["work"].flops * rec["micro_steps"], rec) if rec.get("ops") else None
