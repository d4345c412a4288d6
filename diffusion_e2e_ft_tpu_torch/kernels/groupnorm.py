"""GroupNorm(+SiLU) in plain PyTorch with fp32 one-pass statistics.

Mirrors `diffusion_e2e_ft_tpu/kernels/groupnorm.py::_xla_group_norm`, the
path the JAX package runs by default: per-channel fp32 sums of x and x^2,
folded C -> G, variance E[x^2] - E[x]^2 clamped at 0, normalize, affine and
optional SiLU in fp32, result cast back to the input dtype. (The TPU stats
kernel there is opt-in and is not on this path.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm_silu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    silu: bool = True,
) -> torch.Tensor:
    """[B, C, H, W] (or [B, C, N]) GroupNorm with optional fused SiLU."""
    b, c = x.shape[:2]
    gs = c // groups
    xf = x.float().reshape(b, c, -1)
    n = xf.shape[-1]
    s = xf.sum(-1)  # [B, C]
    ss = (xf * xf).sum(-1)
    count = float(n * gs)
    mean_g = s.reshape(b, groups, gs).sum(-1) / count  # [B, G]
    var_g = (ss.reshape(b, groups, gs).sum(-1) / count - mean_g * mean_g).clamp_min(0.0)
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(gs, dim=-1)[:, :, None]  # [B, C, 1]
    inv_c = inv_g.repeat_interleave(gs, dim=-1)[:, :, None]
    out = (xf - mean_c) * inv_c
    out = out * weight.float()[:, None] + bias.float()[:, None]
    if silu:
        out = F.silu(out)
    return out.to(x.dtype).reshape(x.shape)
