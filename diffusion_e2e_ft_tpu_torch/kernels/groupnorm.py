"""GroupNorm(+SiLU) in plain PyTorch with fp32 one-pass statistics, and the
Hopper kernel for those statistics.

`group_norm_silu` mirrors `diffusion_e2e_ft_tpu/kernels/groupnorm.py::_xla_group_norm`,
the path the JAX package runs by default: per-channel fp32 sums of x and x^2,
folded C -> G, variance E[x^2] - E[x]^2 clamped at 0, normalize, affine and
optional SiLU in fp32, result cast back to the input dtype. It stays plain on
both devices, as the JAX package keeps its statistics kernel opt-in there.

`channel_stats` launches `csrc/groupnorm.cu`, which replaces the TPU kernel
`::_stats_kernel` (launched by `_channel_stats`): the per-channel sums alone,
which feed the fused GroupNorm+SiLU -> conv kernel (`kernels/gn_conv.py`).
`channel_stats_reference` is its plain version. The kernel splits a long
row over a cluster of `stats_parts(B * C, N)` blocks and adds their sums in
rank order; `STATS_SPLIT` mirrors its constants (a test parses the source).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.kernels import _build

# Kernel launches since the last `reset_launches()`.
launches = {"gn_channel_stats": 0}
# `csrc/groupnorm.cu`: blocks a (b, c) row at most, values a block at least before a row is split further,
# and resident blocks an SM
STATS_SPLIT = {"kStatsMaxParts": 8, "kStatsMinSegment": 16384, "kStatsBlocksPerSm": 8}


def stats_parts(rows: int, n: int, sms: int = 132) -> int:
    """Blocks (a cluster) that reduce one of `rows` rows of n values, on a
    card of `sms` SMs (132: the H100 SXM): the kernel's rule."""
    parts, wave = 1, sms * STATS_SPLIT["kStatsBlocksPerSm"]
    while (parts < STATS_SPLIT["kStatsMaxParts"] and n // (2 * parts) >= STATS_SPLIT["kStatsMinSegment"]
           and rows * parts * 2 <= wave):
        parts *= 2
    return parts


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def channel_stats_reference(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] (or [B, C, N]) -> fp32 [B, 2, C]: per-channel sum x, sum x^2."""
    xf = x.float().reshape(x.shape[0], x.shape[1], -1)
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=1)


def check_kernel_operand(fn: str, name: str, t: torch.Tensor) -> None:
    """Raise unless `t` is a contiguous fp32 or bf16 CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{fn}: {name} is on {t.device}, the kernel needs a CUDA tensor")
    if t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel takes float32 or bfloat16")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """`channel_stats_reference` with the CUDA kernel; takes a contiguous fp32
    or bf16 CUDA tensor and raises on anything else."""
    check_kernel_operand("channel_stats", "x", x)
    if x.ndim not in (3, 4) or x.numel() == 0:
        raise ValueError(f"channel_stats: x must be a non-empty [B, C, H, W] or [B, C, N], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    _build.launch(launches, "gn_channel_stats", x, x.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[x.dtype],
                  b, c, x[0, 0].numel())
    return out


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
