"""SD2-family conditional UNet (NCHW), port of `diffusion_e2e_ft_tpu/models/unet.py`.

Covers the Marigold / E2E-FT configuration (8-channel input: image latent ++
noisy latent, cross-attention over the CLIP empty-prompt embedding, linear
transformer projections) and GeoWizard's (`UNetConfig.geowizard()`): the
SD1.5 shape (8 heads per level, cross-attention dim 768, 1x1-conv
projections), a projection class embedding of the 10-dim task / domain
switcher added to the time embedding, and joint cross-task self-attention.
`UNetConfig.sdxl()` is the SDXL-base UNet under the same 8-channel
conditioning: three levels, transformer stacks 1 / 2 / 10 deep (the mid
block as deep as the last level), cross-attention over a 2048-wide context
and diffusers' "text_time" added embedding (a pooled text embedding and the
sinusoids of six size and crop ids, lifted to the time embedding's width
and added to it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from diffusion_e2e_ft_tpu_torch.models.layers import (
    Downsample,
    GroupNormAct,
    ResnetBlock,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample,
    timestep_embedding,
)
from diffusion_e2e_ft_tpu_torch.utils import graphs, trace


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    transformer_depth: Union[int, Tuple[int, ...]] = 1  # blocks a transformer stack, per level (an int: every level)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    use_linear_projection: bool = True
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # GeoWizard extensions
    class_embed_proj_dim: Optional[int] = None  # 10 for GeoWizard's switcher
    joint_attention: bool = False
    # SDXL's added embedding: "text_time" adds linear_2(silu(linear_1([pooled text; sinusoids of the time ids])))
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256  # sinusoid width of each time id
    addition_embed_input_dim: Optional[int] = None  # the pooled width + 6 x addition_time_embed_dim (2816)

    def __post_init__(self):
        if len(self.transformer_depths) != len(self.block_out_channels):
            raise ValueError(f"transformer_depth {self.transformer_depth} does not give one depth a level")
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unsupported addition_embed_type {self.addition_embed_type!r}")
        if self.addition_embed_type is not None and self.addition_embed_input_dim is None:
            raise ValueError("addition_embed_type 'text_time' needs addition_embed_input_dim")

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def transformer_depths(self) -> Tuple[int, ...]:
        d = self.transformer_depth
        return (d,) * len(self.block_out_channels) if isinstance(d, int) else d

    @staticmethod
    def sd2(**kw) -> "UNetConfig":
        return UNetConfig(**kw)

    @staticmethod
    def sd15(**kw) -> "UNetConfig":
        base = dict(num_attention_heads=(8, 8, 8, 8), cross_attention_dim=768, use_linear_projection=False)
        base.update(kw)
        return UNetConfig(**base)

    @staticmethod
    def geowizard(**kw) -> "UNetConfig":
        base = dict(class_embed_proj_dim=10, joint_attention=True)
        base.update(kw)
        return UNetConfig.sd15(**base)

    @staticmethod
    def sdxl(**kw) -> "UNetConfig":
        """SDXL-base's UNet (stabilityai/stable-diffusion-xl-base-1.0) with Marigold's 8 input channels."""
        base = dict(
            block_out_channels=(320, 640, 1280), cross_attention_levels=(False, True, True),
            num_attention_heads=(5, 10, 20), cross_attention_dim=2048, transformer_depth=(1, 2, 10),
            addition_embed_type="text_time", addition_time_embed_dim=256, addition_embed_input_dim=2816,
        )
        base.update(kw)
        return UNetConfig(**base)

    @staticmethod
    def tiny(**kw) -> "UNetConfig":
        """Test-sized config: same topology, 16x fewer channels."""
        base = dict(
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 2, 2, 2),
            cross_attention_dim=32,
        )
        base.update(kw)
        return UNetConfig(**base)


def _transformer(c: UNetConfig, channels: int, heads: int, depth: int) -> SpatialTransformer:
    return SpatialTransformer(
        channels, heads, channels // heads, c.cross_attention_dim,
        depth=depth, groups=c.norm_num_groups,
        use_linear_projection=c.use_linear_projection, joint_attention=c.joint_attention,
    )


class _DownBlock(nn.Module):
    def __init__(self, c: UNetConfig, level: int, in_ch: int):
        super().__init__()
        out_ch = c.block_out_channels[level]
        heads = c.num_attention_heads[level]
        resnets, attentions = [], []
        for j in range(c.layers_per_block):
            resnets.append(
                ResnetBlock(in_ch if j == 0 else out_ch, out_ch, c.norm_num_groups, c.norm_eps, c.time_embed_dim)
            )
            if c.cross_attention_levels[level]:
                attentions.append(_transformer(c, out_ch, heads, c.transformer_depths[level]))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        is_last = level == len(c.block_out_channels) - 1
        self.downsamplers = None if is_last else nn.ModuleList([Downsample(out_ch)])

    def forward(self, x, temb, context) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        skips = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class _MidBlock(nn.Module):
    def __init__(self, c: UNetConfig):
        super().__init__()
        ch = c.block_out_channels[-1]
        self.resnets = nn.ModuleList(
            [ResnetBlock(ch, ch, c.norm_num_groups, c.norm_eps, c.time_embed_dim) for _ in range(2)]
        )
        self.attentions = nn.ModuleList([_transformer(c, ch, c.num_attention_heads[-1], c.transformer_depths[-1])])

    def forward(self, x, temb, context) -> torch.Tensor:
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class _UpBlock(nn.Module):
    def __init__(self, c: UNetConfig, level: int, in_ch: int, skip_channels: List[int]):
        super().__init__()
        out_ch = tuple(reversed(c.block_out_channels))[level]
        heads = tuple(reversed(c.num_attention_heads))[level]
        has_attn = tuple(reversed(c.cross_attention_levels))[level]
        depth = tuple(reversed(c.transformer_depths))[level]
        resnets, attentions = [], []
        for j, skip_ch in enumerate(skip_channels):
            res_in = (in_ch if j == 0 else out_ch) + skip_ch
            resnets.append(ResnetBlock(res_in, out_ch, c.norm_num_groups, c.norm_eps, c.time_embed_dim))
            if has_attn:
                attentions.append(_transformer(c, out_ch, heads, depth))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        is_last = level == len(c.block_out_channels) - 1
        self.upsamplers = None if is_last else nn.ModuleList([Upsample(out_ch)])

    def forward(self, x, skips: List[torch.Tensor], temb, context, upsample_hw=None) -> torch.Tensor:
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_hw)
        return x


def _timesteps(timesteps, sample: torch.Tensor) -> torch.Tensor:
    """The timestep(s) as a [B] tensor on the sample's device; a Python number
    is filled in there, with no copy from the host."""
    if torch.is_tensor(timesteps):
        timesteps = timesteps.to(sample.device)
    else:
        timesteps = torch.full(sample.shape[:1], timesteps, dtype=torch.as_tensor(timesteps).dtype,
                               device=sample.device)
    return timesteps.expand(sample.shape[0]) if timesteps.ndim == 0 else timesteps


class UNet2DCondition(graphs.Graphed):
    """(latent [B,C,H,W], timestep, context [B,L,D][, class vector [B,P]]
    [, text_embeds [B,E], time_ids [B,6]]) -> prediction [B,4,H,W]. Served at
    a fixed shape, the forward replays a CUDA graph (`utils/graphs.py`), with
    every tensor input among its static inputs."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        c = self.config = config
        ch = c.block_out_channels
        self.time_embedding = TimestepEmbedding(ch[0], c.time_embed_dim)
        self.class_embedding = (
            TimestepEmbedding(c.class_embed_proj_dim, c.time_embed_dim) if c.class_embed_proj_dim is not None else None
        )
        self.add_embedding = (
            TimestepEmbedding(c.addition_embed_input_dim, c.time_embed_dim) if c.addition_embed_type else None
        )
        self.conv_in = nn.Conv2d(c.in_channels, ch[0], 3, padding=1)

        # follow the skip tensors' channels exactly as forward() stacks them
        skip_ch = [ch[0]]
        down = []
        for i, out in enumerate(ch):
            down.append(_DownBlock(c, i, ch[max(i - 1, 0)]))
            skip_ch += [out] * c.layers_per_block + ([out] if i < len(ch) - 1 else [])
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _MidBlock(c)
        up, x_ch = [], ch[-1]
        for i, out in enumerate(reversed(ch)):
            n = c.layers_per_block + 1
            block_skips = list(reversed(skip_ch[-n:]))  # popped last-first
            del skip_ch[-n:]
            up.append(_UpBlock(c, i, x_ch, block_skips))
            x_ch = out
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNormAct(c.norm_num_groups, ch[0], c.norm_eps)
        self.conv_out = nn.Conv2d(ch[0], c.out_channels, 3, padding=1)

    @trace.traced("unet")
    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor,
        encoder_hidden_states: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
        text_embeds: Optional[torch.Tensor] = None,
        time_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self._graphs(self, self._forward, sample, _timesteps(timesteps, sample), encoder_hidden_states,
                            class_labels, text_embeds, time_ids)

    def _forward(self, sample, timesteps, encoder_hidden_states, class_labels=None, text_embeds=None,
                 time_ids=None) -> torch.Tensor:
        c = self.config
        dtype = self.conv_in.weight.dtype
        t_feat = timestep_embedding(
            timesteps, c.block_out_channels[0],
            flip_sin_to_cos=c.flip_sin_to_cos, downscale_freq_shift=c.freq_shift,
        ).to(dtype)
        temb = self.time_embedding(t_feat)
        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("this UNet config requires class_labels")
            temb = temb + self.class_embedding(class_labels.to(dtype))
        if self.add_embedding is not None:
            if text_embeds is None or time_ids is None:
                raise ValueError("this UNet config requires text_embeds and time_ids")
            time_feat = timestep_embedding(
                time_ids.flatten(), c.addition_time_embed_dim,
                flip_sin_to_cos=c.flip_sin_to_cos, downscale_freq_shift=c.freq_shift,
            ).reshape(text_embeds.shape[0], -1)
            temb = temb + self.add_embedding(torch.cat([text_embeds.float(), time_feat], dim=-1).to(dtype))
        context = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))

        skips = [x]
        for block in self.down_blocks:
            x, s = block(x, temb, context)
            skips.extend(s)
        x = self.mid_block(x, temb, context)
        for block in self.up_blocks:
            n = c.layers_per_block + 1
            block_skips = skips[-n:]
            del skips[-n:]
            # odd spatial sizes: upsample to the next skip's resolution, not naive 2x
            up_hw = tuple(skips[-1].shape[2:]) if skips else None
            x = block(x, block_skips, temb, context, up_hw)
        return self.conv_out(self.conv_norm_out(x))
