"""SD2 AutoencoderKL (VAE), NCHW, deterministic-mean latent path.

Port of `diffusion_e2e_ft_tpu/models/vae.py`: `encode_mean` (posterior mean,
no sampling) and `decode`, with the fused GN->conv option and the decoder's
sub-pixel upsamplers (`subpixel_upsample`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from diffusion_e2e_ft_tpu_torch.models.layers import (
    Downsample,
    GroupNormAct,
    ResnetBlock,
    Upsample,
    VAEAttention,
)
from diffusion_e2e_ft_tpu_torch.utils import trace

SD_LATENT_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SD_LATENT_SCALE
    # Every ResnetBlock's GN+SiLU->conv pairs through the fused kernels
    # (kernels/gn_conv.py); the same parameters and math. Off by default, as
    # in the JAX package: `E2ETrainer` turns it on for its own VAE
    # (TrainConfig.fused_vae_kernels), serving keeps it off.
    fused_gn_conv: bool = False
    # The decoder's nearest-2x -> conv3x3 upsamplers as one conv over the
    # input and an interleave (layers._SubpixelConv3x3): the same parameters,
    # exact up to rounding, no [2H, 2W, C] tensor. Off by default, as in the
    # JAX package.
    subpixel_upsample: bool = False


class _EncoderDown(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, add_downsample: bool, groups: int, fused: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, groups, eps=1e-6, fused=fused)
             for j in range(num_layers)]
        )
        self.downsamplers = (
            nn.ModuleList([Downsample(out_ch, asymmetric=True)]) if add_downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class _Mid(nn.Module):
    def __init__(self, channels: int, groups: int, fused: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(channels, channels, groups, eps=1e-6, fused=fused) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        ch = c.block_out_channels
        self.conv_in = nn.Conv2d(c.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [
                _EncoderDown(
                    ch[max(i - 1, 0)], out, c.layers_per_block, i < len(ch) - 1, c.norm_num_groups,
                    c.fused_gn_conv,
                )
                for i, out in enumerate(ch)
            ]
        )
        self.mid_block = _Mid(ch[-1], c.norm_num_groups, c.fused_gn_conv)
        self.conv_norm_out = GroupNormAct(c.norm_num_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * c.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class _DecoderUp(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, add_upsample: bool, groups: int, fused: bool,
                 subpixel: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else out_ch, out_ch, groups, eps=1e-6, fused=fused)
             for j in range(num_layers)]
        )
        self.upsamplers = nn.ModuleList([Upsample(out_ch, subpixel=subpixel)]) if add_upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        up = tuple(reversed(c.block_out_channels))
        self.conv_in = nn.Conv2d(c.latent_channels, up[0], 3, padding=1)
        self.mid_block = _Mid(up[0], c.norm_num_groups, c.fused_gn_conv)
        self.up_blocks = nn.ModuleList(
            [
                _DecoderUp(
                    up[max(i - 1, 0)], out, c.layers_per_block + 1, i < len(up) - 1, c.norm_num_groups,
                    c.fused_gn_conv, c.subpixel_upsample,
                )
                for i, out in enumerate(up)
            ]
        )
        self.conv_norm_out = GroupNormAct(c.norm_num_groups, up[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(up[-1], c.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """Encoder + decoder + quant convs; `encode_mean` is the deterministic path."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    @trace.traced("encode")
    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] in [-1,1] -> posterior mean [B,4,H/8,W/8] (not scaled)."""
        moments = self.quant_conv(self.encoder(x))
        return moments[:, : self.config.latent_channels]

    @trace.traced("decode")
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B,4,h,w] (unscaled) -> [B,3,8h,8w]."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode_mean(x))
