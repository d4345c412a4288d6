"""Shared building blocks for the SD2 and SD1.5-family models (NCHW, torch.nn).

Parameter names are the HF/diffusers keys, so a published state dict loads
with `load_state_dict(strict=True)`. Norms compute in fp32 and cast back to
the module's dtype, as in the JAX package (`diffusion_e2e_ft_tpu/models/layers.py`).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusion_e2e_ft_tpu_torch import kernels
from diffusion_e2e_ft_tpu_torch.kernels.gn_conv import gn_silu_conv3x3
from diffusion_e2e_ft_tpu_torch.kernels.groupnorm import group_norm_silu


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep features [B, dim] in fp32 (SD2 layout: cos first)."""
    half = dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer MLP lifting sinusoidal features to the embedding width."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNormAct(nn.Module):
    """GroupNorm with optional fused SiLU; fp32 one-pass statistics.

    `kernels.groupnorm.group_norm_silu`: the plain version on the CPU; on the
    card one C call a GroupNorm (one kernel launch where a group fits on
    chip, else the statistics and apply kernels), through
    `GroupNormFunction` when a gradient is wanted."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5, silu: bool = True):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.groups, self.eps, self.silu)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv3x3 (+ time-emb shift) -> GN -> SiLU -> conv3x3, residual.

    With `fused=True` both GN+SiLU -> conv pairs go through
    `kernels.gn_conv.gn_silu_conv3x3` (the fused kernels on the card, the
    plain composite on the CPU), as the JAX package's `fused` ResnetBlock.
    The parameters are the same modules either way, so state dicts are
    interchangeable."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        groups: int = 32,
        eps: float = 1e-5,
        temb_channels: Optional[int] = None,
        fused: bool = False,
    ):
        super().__init__()
        self.fused = fused
        self.norm1 = GroupNormAct(groups, in_channels, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            nn.Linear(temb_channels, out_channels) if temb_channels is not None else None
        )
        self.norm2 = GroupNormAct(groups, out_channels, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.fused:
            return self._fused_forward(x, temb)
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h

    def _fused_forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        n1, n2 = self.norm1, self.norm2
        h = gn_silu_conv3x3(x, n1.weight, n1.bias, n1.groups, n1.eps, self.conv1.weight, self.conv1.bias)
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return gn_silu_conv3x3(h, n2.weight, n2.bias, n2.groups, n2.eps, self.conv2.weight, self.conv2.bias,
                               residual=residual)


class Downsample(nn.Module):
    """Stride-2 conv. The VAE encoder variant pads bottom/right only."""

    def __init__(self, channels: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class _SubpixelConv3x3(nn.Conv2d):
    """A 3x3 conv (the plain `nn.Conv2d`: the same parameters, names and
    forward) whose `upsample2x` computes conv3x3(nearest2x(x)) without the
    2x tensor, port of `diffusion_e2e_ft_tpu/models/layers.py::_SubpixelConv3x3`.

    An output pixel (2i + a, 2j + b) sees input rows {i + a - 1, i + a} and
    columns {j + b - 1, j + b} through 2x2 kernels whose taps are sums of the
    3x3 taps (rows a = 0: (w0, w1 + w2), a = 1: (w0 + w1, w2); columns
    alike). So the four parities are one conv with a [4 Cout, C, 2, 2] weight
    (folded in fp32) over the input padded to (H + 2) x (W + 2), giving
    (H + 1) x (W + 1) windows, and an interleave of the four quadrants:
    16 instead of 36 products an output pixel, exact up to rounding."""

    def folded_weight(self) -> torch.Tensor:
        w = self.weight.float()  # [Cout, C, 3, 3]
        rows = (torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], 2),  # even output rows
                torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], 2))  # odd output rows
        quads = []
        for r in rows:  # [Cout, C, 2, 3] -> columns of even, then odd, outputs
            quads.append(torch.stack([r[..., 0], r[..., 1] + r[..., 2]], -1))
            quads.append(torch.stack([r[..., 0] + r[..., 1], r[..., 2]], -1))
        return torch.cat(quads)  # [4 Cout, C, 2, 2], quadrant (a, b) at 2a + b

    def upsample2x(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        c = self.out_channels
        y = F.conv2d(F.pad(x, (1, 1, 1, 1)), self.folded_weight().to(x.dtype))  # [B, 4 Cout, H + 1, W + 1]
        y00, y01 = y[:, :c, :h, :w], y[:, c:2 * c, :h, 1:]
        y10, y11 = y[:, 2 * c:3 * c, 1:, :w], y[:, 3 * c:, 1:, 1:]
        z = torch.stack([torch.stack([y00, y01], -1), torch.stack([y10, y11], -1)], 3)  # [B, C, H, 2, W, 2]
        return z.reshape(b, c, 2 * h, 2 * w) + self.bias.to(z.dtype)[:, None, None]


class Upsample(nn.Module):
    """Nearest resize (2x, or to an explicit target so odd skips reconnect) + conv.

    `nearest-exact` samples at half-pixel centres, as `jax.image.resize`
    does; plain `nearest` would pick other source rows at odd targets.
    `subpixel=True` computes the exact 2x case as `_SubpixelConv3x3` (the
    same parameters); explicit odd targets keep the resize."""

    def __init__(self, channels: int, subpixel: bool = False):
        super().__init__()
        self.subpixel = subpixel
        self.conv = (_SubpixelConv3x3 if subpixel else nn.Conv2d)(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, out_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        target = tuple(out_hw) if out_hw is not None else (x.shape[2] * 2, x.shape[3] * 2)
        if self.subpixel and target == (x.shape[2] * 2, x.shape[3] * 2):
            return self.conv.upsample2x(x)
        x = F.interpolate(x, size=target, mode="nearest-exact")
        return self.conv(x)


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None. `joint=True`
    runs GeoWizard's cross-task self-attention (keys and values unioned across
    the two task halves of the batch)."""

    def __init__(
        self,
        query_dim: int,
        num_heads: int,
        head_dim: int,
        context_dim: Optional[int] = None,
        out_bias: bool = True,
        joint: bool = False,
    ):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim, self.joint = num_heads, head_dim, joint
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, lq, _ = x.shape
        lk = ctx.shape[1]
        q = self.to_q(x).view(b, lq, self.num_heads, self.head_dim)
        k = self.to_k(ctx).view(b, lk, self.num_heads, self.head_dim)
        v = self.to_v(ctx).view(b, lk, self.num_heads, self.head_dim)
        if self.joint and context is None:
            out = kernels.joint_attention(q, k, v)
        else:
            out = kernels.attention(q, k, v)
        return self.to_out[0](out.reshape(b, lq, self.num_heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) GELU, as diffusers


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index 1 is the (inference no-op) dropout, kept so keys read net.0 / net.2
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class LayerNormFP32(nn.LayerNorm):
    """LayerNorm with fp32 statistics, as flax's: the input cast up, the output back.

    On the card an input of the affine's dtype takes one launch: PyTorch's
    CUDA kernel keeps the statistics and the affine in fp32 and rounds once
    on the way out, as the casts around an fp32 call do (four launches more
    a norm)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype == self.weight.dtype:
            return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class TokenConv1x1(nn.Conv2d):
    """A 1x1 conv (HF's [out, in, 1, 1] weight) on [B, L, in] tokens, as the
    linear map it is."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=1)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.linear(tokens, self.weight.flatten(1), self.bias)


class TransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int, joint_attention: bool = False):
        super().__init__()
        self.norm1 = LayerNormFP32(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads, head_dim, joint=joint_attention)
        self.norm2 = LayerNormFP32(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, num_heads, head_dim, context_dim)
        self.norm3 = LayerNormFP32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN -> proj_in -> transformer blocks -> proj_out, residual.

    SD2 uses linear projections (`use_linear_projection=True`); the SD1.5
    family (GeoWizard) uses 1x1 convs, whose HF keys hold [out, in, 1, 1]
    weights. Both compute the same per-pixel affine map."""

    def __init__(
        self,
        channels: int,
        num_heads: int,
        head_dim: int,
        context_dim: int,
        depth: int = 1,
        groups: int = 32,
        use_linear_projection: bool = True,
        joint_attention: bool = False,
    ):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = GroupNormAct(groups, channels, eps=1e-6, silu=False)
        proj = nn.Linear if use_linear_projection else TokenConv1x1
        self.proj_in = proj(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, num_heads, head_dim, context_dim, joint_attention) for _ in range(depth)]
        )
        self.proj_out = proj(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hidden = self.proj_in(hidden)
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        return self.proj_out(hidden).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid blocks."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = GroupNormAct(groups, channels, eps=eps, silu=False)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(hidden).view(b, h * w, 1, c)
        k = self.to_k(hidden).view(b, h * w, 1, c)
        v = self.to_v(hidden).view(b, h * w, 1, c)
        out = kernels.attention(q, k, v).reshape(b, h * w, c)
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
