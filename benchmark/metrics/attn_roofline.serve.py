"""Share of the roofline of the self-attention of the traced requests: the
least time of every UNet self-attention (joint attention as its [B, 2L]
call) and VAE mid-block attention of each request, forward, from the
reference's shapes (`work/roofline.py::attention_fwd`, bf16 operands), over
the device time of the kernels whose names say attention: the program's
flash kernels and the library's fused attention, so that a kernel swapped
for another still counts."""

from lib.readers import matched_s, per_request_work, share
from work import roofline as R

LAYER = "kernels"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "requests_per_s"
NAMES = ("flash", "fmha", "attention", "sdpa", "mem_eff", "cutlass_attn")
NOT = ("bwd", "backward")


def read(rec):
    if not rec.get("ops"):
        return None
    bound = sum(R.roofline_s(*R.attention_fwd(*call)) for w in per_request_work(rec) for call in w.attention)
    return share(bound, matched_s(rec, NAMES, NOT))
