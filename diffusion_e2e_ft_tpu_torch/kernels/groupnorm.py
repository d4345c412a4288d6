"""GroupNorm(+SiLU) with fp32 one-pass statistics: the plain PyTorch
version, the Hopper kernels' wrappers, the autograd Function and the
dispatcher. Port of `diffusion_e2e_ft_tpu/kernels/groupnorm.py`.

- `group_norm_reference` mirrors `_xla_group_norm`: per-channel fp32 sums of
  x and x^2, folded C -> G, variance E[x^2] - E[x]^2 clamped at 0,
  normalize, affine and optional SiLU in fp32, the result cast back to the
  input dtype. It is the CPU path, and what the backward recomputes.
- `channel_stats` launches `csrc/groupnorm.cu`'s statistics kernel, which
  replaces the TPU kernel `::_stats_kernel` (launched by `_channel_stats`):
  the per-channel sums alone. `channel_stats_reference` is its plain
  version. The kernel splits a long row over a cluster of
  `stats_parts(B * C, N)` blocks and adds their sums in rank order;
  `STATS_SPLIT` mirrors its constants (a test parses the source). Its
  caller: the fused GN -> conv (`kernels/gn_conv.py`); `group_norm_kernel`
  reaches the same kernel from C.
- `group_norm_apply` launches `csrc/groupnorm.cu`'s apply kernel, which
  replaces no Pallas kernel but the XLA normalize + affine + SiLU that
  follows `_stats_kernel` in `_pallas_group_norm`: `fold_stats`' a, b, then
  x * a + b and the optional SiLU in fp32. `group_norm_apply_reference` is
  its plain version.
- `group_norm_kernel` mirrors `_pallas_group_norm` in one C call
  (`e2eft_group_norm`): where a (b, g) slab of x fits the shared memory of
  a cluster (`group_fits`; `GROUP_RULE` mirrors the source's constants), one
  launch of `csrc/groupnorm.cu::gn_group_kernel`, which replaces
  `_stats_kernel` and XLA's apply together; elsewhere (the VAE's 384x384
  and 768x768 layers) the statistics kernel, then the apply. The choice is
  the shape's and dtype's alone; `group_norm_reference` is the plain version
  of both. `GroupNormFunction` mirrors `_fused`: the forward runs the
  kernels and saves x and the affine; the backward recomputes
  `group_norm_reference` and returns its vector-Jacobian product.
- `group_norm_silu` dispatches, as the JAX function of that name: a CPU
  tensor takes `group_norm_reference`; a CUDA tensor takes the kernels (alone
  when no gradient is wanted, through `GroupNormFunction` when one is) or
  raises. Their envelope: x fp32 or bf16, [B, C, H, W] or [B, C, N],
  non-empty, C a multiple of `groups`; the affine fp32 or bf16, on x's
  device. x is made contiguous first, as `gn_conv.gn_silu_conv3x3` does: an
  NHWC image permuted to NCHW reaches the VAE encoder's first conv as a
  channels_last tensor, and the convs and residual adds carry that layout
  on through the encoder and into the UNet; the plain version
  copies such an x too (its reshape), so both paths hand the next layer the
  same contiguous layout. Unlike the JAX package there is no switch, no
  fallback and no lane rule on C: eager PyTorch has no fusion that the
  kernels could disturb, and the statistics kernel takes any C.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.kernels import _build

# Kernel launches since the last `reset_launches()`.
launches = {"gn_channel_stats": 0, "gn_apply": 0, "gn_group": 0}
# `csrc/groupnorm.cu`: blocks a (b, c) row at most, values a block at least before a row is split further,
# and resident blocks an SM
STATS_SPLIT = {"kStatsMaxParts": 8, "kStatsMinSegment": 16384, "kStatsBlocksPerSm": 8}
# `csrc/groupnorm.cu`, the one-launch GroupNorm: blocks (a cluster) a (b, g) slab at most, dynamic shared
# memory a block at most (its share of the slab, then the group's a, b), and bytes of a share at least before a
# slab is split further
GROUP_RULE = {"kGroupMaxParts": 8, "kGroupSmemBytes": 229376, "kGroupMinShareBytes": 16384}


def stats_parts(rows: int, n: int, sms: int = 132) -> int:
    """Blocks (a cluster) that reduce one of `rows` rows of n values, on a
    card of `sms` SMs (132: the H100 SXM): the kernel's rule."""
    parts, wave = 1, sms * STATS_SPLIT["kStatsBlocksPerSm"]
    while (parts < STATS_SPLIT["kStatsMaxParts"] and n // (2 * parts) >= STATS_SPLIT["kStatsMinSegment"]
           and rows * parts * 2 <= wave):
        parts *= 2
    return parts


def group_smem(slab_bytes: int, gs: int, parts: int) -> int:
    """Dynamic shared memory of a block of the one-launch kernel: the largest
    of `parts` shares of a slab's 16-byte vectors, then gs fp32 a and b."""
    return (slab_bytes // 16 + parts - 1) // parts * 16 + 8 * gs


def group_parts(rows: int, slab_bytes: int, gs: int, sms: int = 132) -> int:
    """Blocks (a cluster) that take one of `rows` (b, g) slabs of slab_bytes
    bytes and gs channels on a card of `sms` SMs (132: the H100 SXM): the
    kernel's rule. 0: the slab does not fit, and the GroupNorm takes the
    statistics kernel and the apply."""
    parts = 1
    while group_smem(slab_bytes, gs, parts) > GROUP_RULE["kGroupSmemBytes"]:
        if parts == GROUP_RULE["kGroupMaxParts"]:
            return 0
        parts *= 2
    while (parts < GROUP_RULE["kGroupMaxParts"] and slab_bytes // (2 * parts) >= GROUP_RULE["kGroupMinShareBytes"]
           and rows * parts * 2 <= sms):
        parts *= 2
    return parts


def slab_fits(slab_bytes: int, gs: int) -> bool:
    """`group_parts(...) > 0` on any card: the slab fits when it fits
    kGroupMaxParts blocks."""
    return group_smem(slab_bytes, gs, GROUP_RULE["kGroupMaxParts"]) <= GROUP_RULE["kGroupSmemBytes"]


def group_fits(shape, dtype: torch.dtype, groups: int) -> bool:
    """Whether a GroupNorm of an x of `shape` ([B, C, H, W] or [B, C, N]) and
    `dtype` takes the one-launch kernel: its slab's bytes and channels alone
    decide."""
    gs = shape[1] // groups
    return slab_fits(gs * math.prod(shape[2:]) * dtype.itemsize, gs)


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
                  b, c, x.numel() // (b * c))
    return out


def group_norm_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    silu: bool = True,
) -> torch.Tensor:
    """[B, C, H, W] (or [B, C, N]) GroupNorm with optional fused SiLU, in plain PyTorch."""
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


def fold_stats(
    stats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, count: int
) -> torch.Tensor:
    """Per-channel sums [B, 2, C] over `count` values per channel -> fp32
    [B, 2, C] (a, b) with GroupNorm(x) = x * a + b: the kernels' fold, as
    `diffusion_e2e_ft_tpu/kernels/gn_conv.py:151-162`."""
    b, _, c = stats.shape
    gs = c // groups
    n = float(count * gs)
    mean_g = stats[:, 0].reshape(b, groups, gs).sum(-1) / n
    var_g = (stats[:, 1].reshape(b, groups, gs).sum(-1) / n - mean_g * mean_g).clamp_min(0.0)
    inv_g = torch.rsqrt(var_g + eps)
    a = inv_g.repeat_interleave(gs, dim=-1) * weight.float()
    return torch.stack([a, bias.float() - mean_g.repeat_interleave(gs, dim=-1) * a], dim=1)


def group_norm_apply_reference(
    x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
    silu: bool = True,
) -> torch.Tensor:
    """x [B, C, H, W] (or [B, C, N]) and its per-channel sums [B, 2, C] ->
    act(x * a + b) in x's dtype, with `fold_stats`' a, b and the arithmetic
    in fp32."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, c, -1)
    ab = fold_stats(stats, weight, bias, groups, eps, xf.shape[-1])
    out = xf * ab[:, 0, :, None] + ab[:, 1, :, None]
    if silu:
        out = F.silu(out)
    return out.to(x.dtype).reshape(x.shape)


def group_norm_apply(
    x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
    silu: bool = True,
) -> torch.Tensor:
    """`group_norm_apply_reference` with the CUDA kernel: x a contiguous fp32
    or bf16 CUDA tensor, stats its contiguous fp32 [B, 2, C] sums, the affine
    [C] in fp32 or bf16 (one dtype for both) on x's device. Raises on
    anything else."""
    check_kernel_operand("gn_apply", "x", x)
    if x.ndim not in (3, 4) or x.numel() == 0:
        raise ValueError(f"gn_apply: x must be a non-empty [B, C, H, W] or [B, C, N], got {tuple(x.shape)}")
    b, c = x.shape[:2]
    if groups <= 0 or c % groups:
        raise ValueError(f"gn_apply: {c} channels do not split into {groups} groups")
    if (stats.device != x.device or stats.dtype != torch.float32 or stats.shape != (b, 2, c)
            or not stats.is_contiguous()):
        raise ValueError(f"gn_apply: stats must be contiguous fp32 [{b}, 2, {c}] on {x.device}, got "
                         f"{stats.dtype} {tuple(stats.shape)} on {stats.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        check_kernel_operand("gn_apply", name, t)
        if t.device != x.device or t.shape != (c,):
            raise ValueError(f"gn_apply: {name} {tuple(t.shape)} on {t.device}, expected [{c}] on {x.device}")
    if weight.dtype != bias.dtype:
        raise TypeError(f"gn_apply: weight {weight.dtype} and bias {bias.dtype} differ")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _build.launch(launches, "gn_apply", x, x.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[weight.dtype], b, c,
                  x.numel() // (b * c), groups, float(eps), int(silu))
    return out


def group_norm_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, silu: bool = True
) -> torch.Tensor:
    """`group_norm_reference` with the CUDA kernels, one C call: the
    one-launch kernel where `group_fits`, else the statistics, then the
    apply. x a contiguous fp32 or bf16 CUDA tensor, [B, C, H, W] or
    [B, C, N], non-empty, C a multiple of `groups`; the affine [C],
    contiguous, fp32 or bf16 (one dtype for both) on x's device. Raises on
    anything else."""
    shape = x.shape
    code = _build.DTYPE_CODES.get(x.dtype)
    if not x.is_cuda:
        raise ValueError(f"group_norm: x is on {x.device}, the kernel needs a CUDA tensor")
    if code is None:
        raise TypeError(f"group_norm: x is {x.dtype}; the kernel takes float32 or bfloat16")
    if len(shape) not in (3, 4) or not x.is_contiguous():
        raise ValueError(f"group_norm: x must be a contiguous [B, C, H, W] or [B, C, N], got {tuple(shape)}")
    b, c = shape[0], shape[1]
    n = shape[2] * shape[3] if len(shape) == 4 else shape[2]
    if b * c * n == 0:
        raise ValueError(f"group_norm: x is empty, {tuple(shape)}")
    if groups <= 0 or c % groups:
        raise ValueError(f"group_norm: {c} channels do not split into {groups} groups")
    index = x.get_device()
    for name, t in (("weight", weight), ("bias", bias)):
        if t.get_device() != index or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"group_norm: {name} {tuple(t.shape)} on {t.device}, expected a contiguous [{c}] on "
                             f"{x.device}")
    affine = _build.DTYPE_CODES.get(weight.dtype)
    if affine is None or weight.dtype != bias.dtype:
        raise TypeError(f"group_norm: weight {weight.dtype} and bias {bias.dtype}; the kernels take one dtype for "
                        "both, float32 or bfloat16")
    out = torch.empty_like(x)
    gs = c // groups
    one = slab_fits(gs * n * x.element_size(), gs)
    stats = None if one else torch.empty((b, 2, c), dtype=torch.float32, device=x.device)  # the route's sums
    kernels = ("gn_group",) if one else ("gn_channel_stats", "gn_apply")
    _build.launch(launches, kernels, x, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  None if one else stats.data_ptr(), code, affine, b, c, n, groups, float(eps), int(silu),
                  entry="group_norm")
    return out


# the forwards the autograd Function runs; its backward is always the plain version's
KERNELS: Callable[..., torch.Tensor] = group_norm_kernel
PLAIN: Callable[..., torch.Tensor] = group_norm_reference


class GroupNormFunction(torch.autograd.Function):
    """Differentiable GroupNorm(+SiLU) through `impl`'s forward; the backward
    recomputes `group_norm_reference`, as the JAX `_fused_bwd`.

    The custom_fwd / custom_bwd decorators run the backward's recompute under
    the forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, weight, bias, groups: int, eps: float, silu: bool, impl: Callable[..., torch.Tensor]):
        ctx.save_for_backward(x, weight, bias)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        return impl(x, weight, bias, groups, eps, silu)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = group_norm_reference(*leaves, ctx.groups, ctx.eps, ctx.silu)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n], grad_out))
        return (*(next(grads) if n else None for n in need), None, None, None, None)


def group_norm_silu(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    silu: bool = True,
) -> torch.Tensor:
    """[B, C, H, W] (or [B, C, N]) GroupNorm with optional fused SiLU: the
    plain version on the CPU, the kernels on the card."""
    if x.device.type != "cuda":
        return group_norm_reference(x, weight, bias, groups, eps, silu)
    x = x.contiguous()  # channels_last activations (see the module's note) are copied, as the plain version does
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return GroupNormFunction.apply(x, weight, bias, groups, eps, silu, KERNELS)
    return group_norm_kernel(x, weight, bias, groups, eps, silu)
