"""Share of the roofline of the standalone GroupNorms of the traced requests:
2 |x| bf16 bytes of every GroupNorm of each request (read once, written
once; from the reference's shapes) over the HBM rate, over the device time
of the kernels whose names say GroupNorm: the program's one-launch, apply
and statistics kernels, and the library's GroupNorm kernels."""

from lib.readers import matched_s, per_request_work, share
from work import roofline as R

LAYER = "kernels"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "requests_per_s"
NAMES = ("gn_group", "gn_apply", "channel_stats", "group_norm", "groupnorm", "rowwisemoments", "computefusedparams")


def read(rec):
    if not rec.get("ops"):
        return None
    nbytes = sum(R.group_norm_bytes(n) for w in per_request_work(rec) for n in w.group_norms)
    return share(nbytes / R.PEAK_HBM_BYTES, matched_s(rec, NAMES))
