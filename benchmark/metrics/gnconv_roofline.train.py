"""Share of the roofline of the fused GroupNorm -> conv3x3 kernels: the
least time of the 3x3 convolutions of every GroupNorm -> conv pair of the
VAE's resnet blocks a micro-step (2 B Cout C 9 H W operations, bf16), from
the reference's shapes, over the device time of the kernels whose names say
gn_conv (the fold of the statistics and the conv; the statistics kernel
and the weight copy are not counted)."""

from lib.readers import matched_s, share
from work import roofline as R

LAYER = "kernels"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "train_img_s"
NAMES = ("gn_conv",)


def read(rec):
    if not rec.get("ops"):
        return None
    bound = sum(f / R.PEAK_BF16_FLOPS for f in rec["work"].gn_conv) * rec["micro_steps"]
    return share(bound, matched_s(rec, NAMES))
