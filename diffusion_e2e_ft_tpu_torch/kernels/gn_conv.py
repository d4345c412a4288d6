"""Fused GroupNorm(+SiLU) -> SAME 3x3 conv: the dispatcher, the plain
composite, the Hopper kernels' wrappers and the autograd Function.

Port of `diffusion_e2e_ft_tpu/kernels/gn_conv.py`, the resnet pairs of the
frozen VAE in training (`VAEConfig.fused_gn_conv`). Tensors are NCHW and the
conv weight OIHW, as the port's modules hold them.

Kernels (CUDA C++ for sm_90a, see the sources' header notes for their design):

- v1 (the default): `kernels/groupnorm.py::channel_stats` (`csrc/groupnorm.cu`,
  replacing `_stats_kernel`), then `csrc/gn_conv.cu`'s conv kernel (replacing
  `_conv_kernel`), which folds the raw sums into the GroupNorm's a, b in its
  prologue: two launches a pair, plus one copy that lays the weight out as
  [Cout, 3, 3, C] in the compute dtype. In bf16 the conv is a `wgmma` body
  whose tiles `BF16_TILE` mirrors; fp32 keeps the scalar `conv_tile` body.
- v2 (`E2EFT_GNCONV_IMPL=v2`, read at each call): `csrc/gn_conv.cu`'s
  single cooperative launch (replacing `_conv_kernel_v2`): a persistent grid
  of one block an SM reduces the (b, c) rows, cut into `parts` segments of
  one warp each, into an fp32 scratch [B, 2, C, parts] that this wrapper
  allocates, passes a grid barrier, then walks the conv's tiles, folding
  a, b at each new image; in bf16 each tile runs v1's `wgmma` body.
  `v2_plan` mirrors its grid and parts rule.

`fold_stats` (from `kernels/groupnorm.py`, re-exported here) is the fold in
plain torch, the kernels' formula, for the tests.

`gn_silu_conv3x3` dispatches by device and a shape-only envelope: a CPU tensor
takes the plain composite `gn_conv_reference`; a CUDA tensor inside the
envelope launches v1 or v2, or raises, with no fallback; a tensor outside it
takes the composite, as the JAX package does for ineligible shapes. The
residual is added outside the kernel, in fp32.

Compute dtype: the autocast dtype of x's device type when autocast is on
there, else x's dtype. x and the weight are cast to it, the statistics and the
normalization run in fp32, and the output is in it.

`GNConvFunction` mirrors the JAX `_fused` custom_vjp: the forward is the
kernel and saves only x and the parameters; the backward recomputes the plain
composite and returns its vector-Jacobian product for the inputs that need
one. It takes its forward as an argument (`KERNELS` or `PLAIN`), so the CPU
tests run the same wiring with the plain version.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.kernels import _build
from diffusion_e2e_ft_tpu_torch.kernels.groupnorm import (  # noqa: F401 (fold_stats: re-exported)
    channel_stats, check_kernel_operand, fold_stats, group_norm_reference,
)

# Kernel launches since the last `reset_launches()`; the statistics kernel
# counts in `groupnorm.launches`.
launches = {"gn_silu_conv3x3": 0, "gn_silu_conv3x3_v2": 0}
IMPLS = ("v1", "v2")
# The bf16 v1 kernel's tiles (`csrc/gn_conv.cu`, namespace `hop`): TH x TW output pixels and BN output
# channels a block, BKC input channels a chunk, a ring of STAGES weight slabs with AHEAD in flight; a test parses
# the source to keep them equal.
BF16_TILE = {"TH": 4, "TW": 64, "BN": 128, "BKC": 64, "STAGES": 5, "AHEAD": 3}
# The fp32 `conv_tile` body's tiles (v1 and v2 in fp32), BK input channels a chunk.
FP32_TILE = {"TH": 8, "TW": 16, "BN": 128, "BK": 32}
# v2's statistics split (`csrc/gn_conv.cu`, `v2_parts`: one warp a segment, V2_WARPS warps a block); a test
# parses the source to keep them equal.
V2_SPLIT = {"kV2MaxParts": 8, "kV2MinSegment": 4096, "kV2FillPct": 90, "kV2StatsUnroll": 8}
V2_WARPS = 8


def conv_blocks(b: int, cout: int, h: int, w: int) -> int:
    """Blocks of one bf16 v1 launch (one a tile of TH x TW pixels and BN channels), one resident an SM."""
    t = BF16_TILE
    return b * -(-h // t["TH"]) * -(-w // t["TW"]) * -(-cout // t["BN"])


def v2_parts(rows: int, n: int, slots: int) -> int:
    """Segments a (b, c) row of n values in v2's statistics phase on `slots`
    warps, as `csrc/gn_conv.cu::v2_parts`: the fewest parts (each segment at
    least kV2MinSegment values unless the row is whole) whose rows * parts
    items fill their waves of `slots` at least kV2FillPct% full; else the
    fullest."""
    s = V2_SPLIT
    best, best_items, best_room = 1, 0, 1
    for p in range(1, s["kV2MaxParts"] + 1):
        if p > 1 and n // p < s["kV2MinSegment"]:
            break
        items = rows * p
        room = -(-items // slots) * slots
        if items * 100 >= room * s["kV2FillPct"]:
            return p
        if items * best_room > best_items * room:
            best, best_items, best_room = p, items, room
    return best


class V2Plan(NamedTuple):
    """One v2 launch: `parts` segments a (b, c) row, the conv's tiles (`tiles_w`
    along w, `tiles_hw` a channel tile, `ntiles` channel tiles; `items` =
    B x tiles_hw x ntiles), and `blocks`, the persistent grid."""

    parts: int
    tiles_w: int
    tiles_hw: int
    ntiles: int
    items: int
    blocks: int


@functools.lru_cache(maxsize=None)
def v2_plan(b: int, c: int, h: int, w: int, cout: int, sms: int, dtype: torch.dtype = torch.bfloat16) -> V2Plan:
    """v2's grid on a card of `sms` SMs, as `launch_v2` computes it: one block
    resident an SM (its shared memory, in both dtypes), and no more blocks
    than the larger phase has items (a statistics item is a warp's, a conv
    item a block's)."""
    t = BF16_TILE if dtype == torch.bfloat16 else FP32_TILE
    full = sms
    parts = v2_parts(b * c, h * w, full * V2_WARPS)
    tiles_w = -(-w // t["TW"])
    tiles_hw = -(-h // t["TH"]) * tiles_w
    ntiles = -(-cout // t["BN"])
    items = b * tiles_hw * ntiles
    return V2Plan(parts, tiles_w, tiles_hw, ntiles, items, min(full, max(-(-b * c * parts // V2_WARPS), items)))


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def impl() -> str:
    """The kernel form, from `E2EFT_GNCONV_IMPL` (default v1), at call time."""
    value = os.environ.get("E2EFT_GNCONV_IMPL", "v1")
    if value not in IMPLS:
        raise ValueError(f"E2EFT_GNCONV_IMPL={value!r}: expected one of {IMPLS}")
    return value


def in_envelope(channels: int, groups: int, kernel_size: Sequence[int]) -> bool:
    """Shape-only predicate: which GN -> conv pairs the kernels serve. The JAX
    envelope (`gn_conv.py:435-442`) without its VMEM term."""
    return channels % groups == 0 and channels % 128 == 0 and tuple(kernel_size) == (3, 3)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


def gn_conv_reference(
    x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor, groups: int, eps: float,
    weight: torch.Tensor, conv_bias: Optional[torch.Tensor], silu: bool = True,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain composite, as the JAX `_xla_gn_conv`: GroupNorm(+SiLU) with
    fp32 statistics cast to the compute dtype, conv3x3 SAME in the compute
    dtype, then the bias and the residual in fp32. Plain on every device: its
    GroupNorm is `group_norm_reference`, never the GroupNorm kernels, so the
    card holds kernels 7 and 8 against plain PyTorch."""
    dt = compute_dtype(x)
    y = group_norm_reference(x.to(dt), gn_weight, gn_bias, groups, eps, silu)
    out = F.conv2d(y, weight.to(dt), padding=1).float()
    if conv_bias is not None:
        out = out + conv_bias.float()[:, None, None]
    if residual is not None:
        out = out + residual.float()
    return out.to(dt)


def gn_conv_kernel(
    x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor, groups: int, eps: float,
    weight: torch.Tensor, conv_bias: Optional[torch.Tensor], silu: bool = True,
) -> torch.Tensor:
    """`gn_conv_reference` (without the residual) with the CUDA kernels, v1 or
    v2 as `impl()` says. x: contiguous fp32 or bf16 [B, C, H, W] on the card;
    weight [Cout, C, 3, 3], laid out and cast to x's dtype here; the
    GroupNorm's affine and the conv bias go to the kernels in fp32. Takes
    what the kernels take (C a multiple of 64), wider than `in_envelope`."""
    form = impl()
    check_kernel_operand("gn_silu_conv3x3", "x", x)
    if x.ndim != 4 or x.numel() == 0:
        raise ValueError(f"gn_silu_conv3x3: x must be a non-empty [B, C, H, W], got {tuple(x.shape)}")
    b, c, h, w = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, c, 3, 3) or c % 64 or c % groups:
        raise ValueError(f"gn_silu_conv3x3: x {tuple(x.shape)}, weight {tuple(weight.shape)}, {groups} groups "
                         "are outside the kernels' limits (a 3x3 weight, C a multiple of 64 and of groups)")
    if b > 65535:
        raise ValueError(f"gn_silu_conv3x3: batch {b} exceeds the kernel's grid")
    for name, t in (("GroupNorm weight", gn_weight), ("GroupNorm bias", gn_bias), ("weight", weight),
                    ("conv bias", conv_bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"gn_silu_conv3x3: {name} is on {t.device}, x on {x.device}")
    # [Cout, 3, 3, C] in the compute dtype, in one copy: each output channel's and tap's run of C contiguous
    wk = torch.empty((cout, 3, 3, c), dtype=x.dtype, device=x.device)
    wk.copy_(weight.detach().permute(0, 2, 3, 1))
    gw, gb = (t.detach().float().contiguous() for t in (gn_weight, gn_bias))
    bias = (conv_bias.detach().float().contiguous() if conv_bias is not None
            else torch.zeros(cout, dtype=torch.float32, device=x.device))
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    params = (gw.data_ptr(), gb.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr())
    sizes = (_build.DTYPE_CODES[x.dtype], int(silu), b, c, cout, h, w, groups, float(eps))
    if form == "v1":
        stats = channel_stats(x)
        _build.launch(launches, "gn_silu_conv3x3", x, x.data_ptr(), stats.data_ptr(), *params, *sizes)
    else:
        parts = v2_plan(b, c, h, w, cout, _sms(x.device), x.dtype).parts
        stats = torch.empty((b, 2, c, parts), dtype=torch.float32, device=x.device)
        _build.launch(launches, "gn_silu_conv3x3_v2", x, x.data_ptr(), *params, stats.data_ptr(), parts, *sizes)
    return out


# the forwards the autograd Function runs; its backward is always the plain composite's
KERNELS: Callable[..., torch.Tensor] = gn_conv_kernel
PLAIN: Callable[..., torch.Tensor] = gn_conv_reference


class GNConvFunction(torch.autograd.Function):
    """Differentiable GroupNorm(+SiLU) -> conv3x3 through `impl`'s forward.

    The custom_fwd / custom_bwd decorators run the backward's recompute under
    the forward's autocast state, so it sees the same compute dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, gn_weight, gn_bias, weight, conv_bias, groups: int, eps: float, silu: bool,
                impl: Callable[..., torch.Tensor]):
        ctx.save_for_backward(x, gn_weight, gn_bias, weight, conv_bias)
        ctx.groups, ctx.eps, ctx.silu = groups, eps, silu
        return impl(x, gn_weight, gn_bias, groups, eps, weight, conv_bias, silu)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:5]
        leaves = [t.detach().requires_grad_(n) if t is not None else None for t, n in zip(ctx.saved_tensors, need)]
        x, gn_weight, gn_bias, weight, conv_bias = leaves
        with torch.enable_grad():
            out = gn_conv_reference(x, gn_weight, gn_bias, ctx.groups, ctx.eps, weight, conv_bias, ctx.silu)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n], grad_out))
        return (*(next(grads) if n else None for n in need), None, None, None, None)


def gn_silu_conv3x3(
    x: torch.Tensor, gn_weight: torch.Tensor, gn_bias: torch.Tensor, groups: int, eps: float,
    weight: torch.Tensor, conv_bias: Optional[torch.Tensor], silu: bool = True,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GroupNorm(+SiLU) -> SAME 3x3 conv (+ residual): [B, C, H, W] -> [B, Cout,
    H, W] in the compute dtype; weight [Cout, C, 3, 3]."""
    if x.device.type != "cuda" or not in_envelope(x.shape[1], groups, weight.shape[2:]):
        return gn_conv_reference(x, gn_weight, gn_bias, groups, eps, weight, conv_bias, silu, residual)
    dt = compute_dtype(x)
    x = x.to(dt).contiguous()
    params = (gn_weight, gn_bias, weight, conv_bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, *params)):
        out = GNConvFunction.apply(x, gn_weight, gn_bias, weight, conv_bias, groups, eps, silu, KERNELS)
    else:  # no gradient wanted (the frozen encoder, serving): the kernel alone
        out = gn_conv_kernel(x, gn_weight, gn_bias, groups, eps, weight, conv_bias, silu)
    if residual is not None:
        out = (out.float() + residual.float()).to(dt)
    return out
