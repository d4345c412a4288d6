"""Share of the roofline of the attention backward: the least time of the
backward (dq, dk, dv: 14 L_q L_k d operations a head) of every
self-attention whose inputs need a gradient (the UNet's, joint attention
as its [B, 2L] call, and the VAE decoder's mid block), from the reference's
shapes, over the device time of the backward attention kernels, the
program's and the library's."""

from lib.readers import matched_s, share
from work import roofline as R

LAYER = "kernels"
SOURCE, UNIT, BETTER, MOVES = "device_trace", "%", "higher", "train_img_s"
NAMES = ("flash_bwd", "fmha_bwd", "attention_bwd", "attention_backward", "mem_eff_bwd", "sdpa_bwd", "flash_attn_bwd")


def read(rec):
    if not rec.get("ops"):
        return None
    w = rec["work"]
    bound = sum(R.roofline_s(*R.attention_bwd(*c)) for c, g in zip(w.attention, w.attention_grad) if g)
    return share(bound * rec["micro_steps"], matched_s(rec, NAMES))
