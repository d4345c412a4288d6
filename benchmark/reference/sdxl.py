"""The plain float32 SDXL-base UNet under Marigold's image conditioning, and
the few-step depth request it serves, written from the published
descriptions in plain torch from the classes of `reference/models.py`.

The UNet is diffusers' UNet2DConditionModel for SDXL-base's config (the
configuration file's `unet` group, stabilityai/stable-diffusion-xl-base-1.0):
three levels (DownBlock2D, CrossAttnDownBlock2D x2 and their mirror),
transformer stacks of `transformer_layers_per_block` blocks a level (1 / 2
/ 10; the mid block takes the last level's), and the "text_time" added
embedding: the six time ids (original size, crop origin, target size)
each through the 256-wide sinusoid (`flip_sin_to_cos`, `freq_shift`),
concatenated after the pooled text embedding, lifted by
`add_embedding` (linear, SiLU, linear) and added to the time embedding.
Parameter names are diffusers' keys, so the program's state dict loads
with `strict=True`.

The request (Marigold, arXiv:2312.02145, its E2E-FT pipeline,
arXiv:2409.11355): resize so the long side is the processing resolution,
map to [-1, 1], VAE encode (the mean, x the VAE's `scaling_factor`), then
trailing-DDIM steps of a v-prediction from a zeros latent on [image latent;
latent], the VAE decode of the last step's x0 estimate, depth the channel
mean clipped and mapped to [0, 1], min-max normalised, resized back.

Departures from diffusers: none in the math. As in `reference/models.py`,
the VAE's posterior is its mean, attention runs in query blocks, and the
last step decodes its x0 estimate, as the repository's Marigold pipelines
do (a deterministic DDIM's last `prev_sample` mixes in a little of its noise
estimate). Every
product goes through the module's `Precision`; TF32 stays off
(`precision.strict_fp32`, which the harness calls before the reference runs).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from reference import models as ref
from reference import pipeline as rp
from reference.precision import strict_fp32

class UNet(ref.UNet):
    """`reference.models.UNet` built at depth 1 without a class embedding,
    each transformer stack then deepened to its level's depth, and the
    text-time embedding added."""

    def __init__(self, cfg: dict):
        if cfg.get("addition_embed_type") != "text_time":
            raise ValueError(f"not an SDXL UNet config: addition_embed_type {cfg.get('addition_embed_type')!r}")
        super().__init__({k: v for k, v in cfg.items() if k != "projection_class_embeddings_input_dim"})
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        depths = cfg["transformer_layers_per_block"]
        depths = list(depths) if isinstance(depths, (list, tuple)) else [depths] * len(ch)
        for blk, depth in zip(self.down_blocks, depths):
            _deepen(blk.attentions, depth, cfg)
        _deepen(self.mid_block.attentions, depths[-1], cfg)
        for blk, depth in zip(self.up_blocks, depths[::-1]):
            _deepen(blk.attentions, depth, cfg)
        self.add_embedding = ref.TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], ch[0] * 4)

    def forward(self, sample, t, context, text_embeds, time_ids):
        cfg = self.cfg
        t = torch.as_tensor(t, device=sample.device)
        if t.ndim == 0:
            t = t.expand(sample.shape[0])
        temb = self.time_embedding(ref.timestep_embedding(
            t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"]))
        time_feat = ref.timestep_embedding(time_ids.flatten(), cfg["addition_time_embed_dim"], cfg["flip_sin_to_cos"],
                                           cfg["freq_shift"]).reshape(text_embeds.shape[0], -1)
        temb = temb + self.add_embedding(torch.cat([text_embeds.float(), time_feat], dim=-1))
        x = self.conv_in(sample.float())
        skips = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if blk.attentions is not None:
                    x = blk.attentions[j](x, context)
                skips.append(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
                skips.append(x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb), context), temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if blk.attentions is not None:
                    x = blk.attentions[j](x, context)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x, tuple(skips[-1].shape[2:]))
        return self.conv_out(self.conv_norm_out(x))


def _deepen(attentions, depth: int, cfg: dict) -> None:
    """Give each transformer stack of a block `depth` blocks (it was built with one)."""
    for st in attentions or ():
        first = st.transformer_blocks[0]
        dim, heads, head_dim = first.attn1.heads * first.attn1.head_dim, first.attn1.heads, first.attn1.head_dim
        st.transformer_blocks.extend(
            ref.TransformerBlock(dim, heads, head_dim, cfg["cross_attention_dim"], False) for _ in range(depth - 1))


class Models(nn.Module):
    """The reference's modules under one root: unet (SDXL), vae."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.unet = UNet(cfg["unet"])
        self.vae = ref.VAE(cfg["vae"])


def build(kind: str, cfg: dict) -> nn.Module:
    return UNet(cfg) if kind == "unet" else ref.build(kind, cfg)


def trailing_plan(sched: dict, steps: int):
    """[(t, prev_t)] of a trailing-spaced plan of `steps` steps, as diffusers' DDIM sets it."""
    if sched["timestep_spacing"] != "trailing":
        raise ValueError(f"unsupported timestep spacing {sched['timestep_spacing']!r}")
    n = sched["num_train_timesteps"]
    ts = np.round(np.arange(n, 0, -n / steps)).astype(np.int64) - 1
    return [(int(t), int(t) - n // steps) for t in ts]


def time_ids(hw, device) -> torch.Tensor:
    """[1, 6]: the processing size as original and target size, the crop at the origin."""
    h, w = hw
    return torch.tensor([[h, w, 0, 0, h, w]], dtype=torch.float32, device=device)


def depth(m, cfg: dict, context: torch.Tensor, pooled: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """[1, h, w, 3] in [-1, 1] -> depth [h, w] in [0, 1] (before min-max)."""
    sched, steps, scale = cfg["scheduler"], cfg["serve"]["denoise_steps"], cfg["vae"]["scaling_factor"]
    lat = m.vae.encode_mean(rgb.permute(0, 3, 1, 2)) * scale
    ids = time_ids(rgb.shape[1:3], rgb.device)
    x = torch.zeros_like(lat)
    plan = trailing_plan(sched, steps)
    for i, (t, prev_t) in enumerate(plan):
        v = m.unet(torch.cat([lat, x], dim=1), t, context, pooled, ids)
        x0 = rp.x0_from_v(sched, x, v, t)
        if i == len(plan) - 1:
            break
        a, a_prev = rp.alpha_bar(sched, t), rp.alpha_bar(sched, prev_t)
        eps = math.sqrt(a) * v + math.sqrt(1.0 - a) * x
        x = math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps
    return rp.depth_from_decoded(m.vae.decode(x0 / scale))[0]


def request(m, cfg: dict, context, pooled, image: np.ndarray) -> Dict[str, np.ndarray]:
    strict_fp32()
    rgb = rp.prepare(image, cfg["serve"]["processing_res"], context.device)
    d = rp.minmax(depth(m, cfg, context, pooled, rgb))
    if tuple(d.shape) != image.shape[:2]:
        d = rp.resize(d[None, ..., None], image.shape[:2], "bilinear")[0, ..., 0]
    return {"depth": d.clamp(0.0, 1.0).cpu().numpy()}
