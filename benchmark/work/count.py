"""The work of a request or a step, counted on the plain reference on the
meta device at the cell's shapes: no kernel of the program is consulted.

`count(fn, root)` runs `fn` (which builds its tensors on the meta device)
under `torch.utils.flop_counter.FlopCounterMode` with hooks on the
reference's modules, and returns a `Work`:

- `flops`: every product's operations (matmuls, convolutions, their
  backwards) as the counter reckons them, attention blocks not recomputed;
- `attention`: each self-attention call as (B, Lq, Lk, heads, d), joint
  attention as the [B, 2L] call it is; `attention_grad` marks the calls
  whose inputs need a gradient;
- `group_norms`: the element count of each GroupNorm's input;
- `gn_conv`: (flops) of each GroupNorm -> 3x3 conv pair of the VAE's resnet
  blocks (the fused pairs of the trainer's VAE).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import models as ref
from work.roofline import conv3x3_flops


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    attention: List[Tuple[int, int, int, int, int]] = dataclasses.field(default_factory=list)
    attention_grad: List[bool] = dataclasses.field(default_factory=list)
    group_norms: List[int] = dataclasses.field(default_factory=list)
    gn_conv: List[float] = dataclasses.field(default_factory=list)


def _hooks(root: torch.nn.Module, work: Work, vae_pairs: bool):
    handles = []

    def on_attention(mod, args):
        x = args[0]
        if len(args) > 1 and args[1] is not None:  # cross-attention: not a kernel call of the envelope
            return
        b, l = x.shape[0], x.shape[1]
        if getattr(mod, "joint", False):
            b, l = b // 2, 2 * l
        work.attention.append((b, l, l, mod.heads, mod.head_dim))
        work.attention_grad.append(torch.is_grad_enabled() and x.requires_grad)

    def on_vae_attention(mod, args):
        x = args[0]
        b, c, h, w = x.shape
        work.attention.append((b, h * w, h * w, 1, c))
        work.attention_grad.append(torch.is_grad_enabled() and x.requires_grad)

    def on_group_norm(mod, args):
        work.group_norms.append(args[0].numel())

    def on_vae_resnet(mod, args):
        b, c, h, w = args[0].shape
        cout = mod.conv1.out_channels
        work.gn_conv += [conv3x3_flops(b, c, cout, h, w), conv3x3_flops(b, cout, cout, h, w)]

    for name, m in root.named_modules():
        if isinstance(m, ref.Attention):
            handles.append(m.register_forward_pre_hook(on_attention))
        elif isinstance(m, ref.VAEAttention):
            handles.append(m.register_forward_pre_hook(on_vae_attention))
        elif isinstance(m, ref.GroupNorm):
            handles.append(m.register_forward_pre_hook(on_group_norm))
        elif vae_pairs and isinstance(m, ref.ResnetBlock) and name.startswith("vae."):
            handles.append(m.register_forward_pre_hook(on_vae_resnet))
    return handles


def count(fn: Callable[[], None], root: torch.nn.Module, vae_pairs: bool = False) -> Work:
    """`root` holds the reference modules (as children named unet, vae, image_encoder)."""
    work = Work()
    ref.set_recompute(root, False)
    handles = _hooks(root, work, vae_pairs)
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
        work.flops = float(counter.get_total_flops())
    finally:
        for h in handles:
            h.remove()
        ref.set_recompute(root, True)
    return work
