"""Plain float32 models: the SD2 / SD1.5-family conditional UNet (with
GeoWizard's class embedding and joint attention), the SD VAE and the CLIP
ViT image tower, written from their published descriptions in plain torch.

Parameter names are the HF/diffusers keys, so one state dict loads into
these modules and into the program's. No kernel, no fused path: GroupNorm
is `F.group_norm`, attention is softmax(q k^T / sqrt(d)) v computed in
blocks of 2048 queries (recomputed in the backward, so that a 9600-token
joint attention fits), each product goes through the module's `Precision`
(`reference/precision.py`). Departures from diffusers: none in the math; the
VAE's posterior is its mean, as the pipelines use it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from reference.precision import FP32, Precision

QUERY_BLOCK = 2048


def set_precision(module: nn.Module, prec: Precision) -> nn.Module:
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d, Attention, VAEAttention, CLIPAttention)):
            m.prec = prec
    return module


def set_recompute(module: nn.Module, on: bool) -> nn.Module:
    """Attention blocks recomputed in the backward (memory) or saved (counting work)."""
    for m in module.modules():
        if isinstance(m, (Attention, VAEAttention, CLIPAttention)):
            m.recompute = on
    return module


class Linear(nn.Linear):
    prec = FP32

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    prec = FP32

    def forward(self, x):
        return self.prec.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float, silu: bool):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.weight.float(), self.bias.float(), self.eps)
        return F.silu(y) if self.silu else y


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)


def _attend_block(prec: Precision, q, k, v, scale: float):
    logits = prec.einsum("bqnd,bknd->bnqk", q, k) * scale
    return prec.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1), v)


def attend(prec: Precision, q, k, v, recompute: bool = True) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D], in query blocks, each
    recomputed in the backward unless `recompute` is off."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for s in range(0, q.shape[1], QUERY_BLOCK):
        qb = q[:, s:s + QUERY_BLOCK]
        if recompute and torch.is_grad_enabled() and (qb.requires_grad or k.requires_grad):
            outs.append(checkpoint(_attend_block, prec, qb, k, v, scale, use_reentrant=False))
        else:
            outs.append(_attend_block(prec, qb, k, v, scale))
    return torch.cat(outs, dim=1)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, out_dim)
        self.linear_2 = Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float, temb: Optional[int] = None):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, True)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout) if temb is not None else None
        self.norm2 = GroupNorm(groups, cout, eps, True)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Downsample(nn.Module):
    def __init__(self, channels: int, asymmetric: bool = False):
        super().__init__()
        self.asymmetric = asymmetric
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric else x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, out_hw=None):
        target = tuple(out_hw) if out_hw is not None else (x.shape[2] * 2, x.shape[3] * 2)
        return self.conv(F.interpolate(x, size=target, mode="nearest-exact"))


class Attention(nn.Module):
    """Multi-head attention; `joint`: GeoWizard's cross-task self-attention, each
    half of a [depth; normal] batch attending over both halves' tokens."""

    prec, recompute = FP32, True

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: Optional[int] = None, joint: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.joint = heads, head_dim, joint
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, lq, _ = x.shape
        q = self.to_q(x).view(b, lq, self.heads, self.head_dim)
        k = self.to_k(ctx).view(b, ctx.shape[1], self.heads, self.head_dim)
        v = self.to_v(ctx).view(b, ctx.shape[1], self.heads, self.head_dim)
        if self.joint and context is None:
            half = b // 2

            def pair(t):  # [2B, L, N, D] -> [B, 2L, N, D]
                return t.reshape(2, half, lq, self.heads, self.head_dim).transpose(0, 1).reshape(
                    half, 2 * lq, self.heads, self.head_dim)

            out = attend(self.prec, pair(q), pair(k), pair(v), self.recompute)
            out = out.reshape(half, 2, lq, self.heads, self.head_dim).transpose(0, 1)
        else:
            out = attend(self.prec, q, k, v, self.recompute)
        return self.to_out[0](out.reshape(b, lq, self.heads * self.head_dim))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TokenConv1x1(Conv2d):
    """A 1x1 conv (HF's [out, in, 1, 1] weight) applied to [B, L, C] tokens."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, kernel_size=1)

    def forward(self, tokens):
        return self.prec.linear(tokens, self.weight.flatten(1), self.bias)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int, joint: bool):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, joint=joint)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, context_dim: int, groups: int, linear_proj: bool, joint: bool):
        super().__init__()
        head_dim = channels // heads
        self.norm = GroupNorm(groups, channels, 1e-6, False)
        proj = Linear if linear_proj else TokenConv1x1
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(channels, heads, head_dim, context_dim, joint)])
        self.proj_out = proj(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        hidden = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for block in self.transformer_blocks:
            hidden = block(hidden, context)
        return self.proj_out(hidden).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel for the configs' keys (`cfg`: the
    configuration file's `unet` group): CrossAttnDownBlock2D x3 + DownBlock2D,
    UNetMidBlock2DCrossAttn, UpBlock2D + CrossAttnUpBlock2D x3, transformer
    depth 1; an optional projection class embedding added to the time
    embedding."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg["block_out_channels"])
        heads = cfg["attention_head_dim"]  # diffusers' name for the head count per level
        heads = list(heads) if isinstance(heads, (list, tuple)) else [heads] * len(ch)
        groups, eps, ctx_dim = cfg["norm_num_groups"], cfg["norm_eps"], cfg["cross_attention_dim"]
        linear, joint = cfg["use_linear_projection"], cfg.get("joint_attention", False)
        attn_levels = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        temb = ch[0] * 4
        n_layers = cfg["layers_per_block"]
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        proj_dim = cfg.get("projection_class_embeddings_input_dim")
        self.class_embedding = TimestepEmbedding(proj_dim, temb) if proj_dim else None
        self.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)

        def transformer(c, n):
            return SpatialTransformer(c, n, ctx_dim, groups, linear, joint)

        self.down_blocks = nn.ModuleList()
        skip_ch = [ch[0]]
        for i, out in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(ch[max(i - 1, 0)] if j == 0 else out, out, groups, eps, temb) for j in range(n_layers)])
            blk.attentions = nn.ModuleList([transformer(out, heads[i]) for _ in range(n_layers)]) \
                if attn_levels[i] else None
            blk.downsamplers = nn.ModuleList([Downsample(out)]) if i < len(ch) - 1 else None
            self.down_blocks.append(blk)
            skip_ch += [out] * n_layers + ([out] if i < len(ch) - 1 else [])
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([ResnetBlock(ch[-1], ch[-1], groups, eps, temb) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList([transformer(ch[-1], heads[-1])])
        self.up_blocks = nn.ModuleList()
        x_ch, rch, rheads, rattn = ch[-1], ch[::-1], heads[::-1], attn_levels[::-1]
        for i, out in enumerate(rch):
            blk = nn.Module()
            skips = list(reversed(skip_ch[-(n_layers + 1):]))
            del skip_ch[-(n_layers + 1):]
            blk.resnets = nn.ModuleList(
                [ResnetBlock((x_ch if j == 0 else out) + s, out, groups, eps, temb) for j, s in enumerate(skips)])
            blk.attentions = nn.ModuleList([transformer(out, rheads[i]) for _ in skips]) if rattn[i] else None
            blk.upsamplers = nn.ModuleList([Upsample(out)]) if i < len(ch) - 1 else None
            self.up_blocks.append(blk)
            x_ch = out
        self.conv_norm_out = GroupNorm(groups, ch[0], eps, True)
        self.conv_out = Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, sample, t, context, class_labels=None):
        cfg = self.cfg
        t = torch.as_tensor(t, device=sample.device)
        if t.ndim == 0:
            t = t.expand(sample.shape[0])
        temb = self.time_embedding(timestep_embedding(
            t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"]))
        if self.class_embedding is not None:
            temb = temb + self.class_embedding(class_labels.float())
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


class VAEAttention(nn.Module):
    prec, recompute = FP32, True

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6, False)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (f(hidden).view(b, h * w, 1, c) for f in (self.to_q, self.to_k, self.to_v))
        out = self.to_out[0](attend(self.prec, q, k, v, self.recompute).reshape(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def _vae_mid(channels: int, groups: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock(channels, channels, groups, 1e-6) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(channels, groups)])
    return mid


def _run_mid(mid: nn.Module, x):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))


class VAE(nn.Module):
    """diffusers' AutoencoderKL (`cfg`: the configuration file's `vae` group):
    `encode_mean` is the posterior mean, `decode` the decoder."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, groups, n = list(cfg["block_out_channels"]), cfg["norm_num_groups"], cfg["layers_per_block"]
        lat = cfg["latent_channels"]
        self.latent_channels = lat
        enc = self.encoder = nn.Module()
        enc.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        for i, out in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(ch[max(i - 1, 0)] if j == 0 else out, out, groups, 1e-6) for j in range(n)])
            blk.downsamplers = nn.ModuleList([Downsample(out, asymmetric=True)]) if i < len(ch) - 1 else None
            enc.down_blocks.append(blk)
        enc.mid_block = _vae_mid(ch[-1], groups)
        enc.conv_norm_out = GroupNorm(groups, ch[-1], 1e-6, True)
        enc.conv_out = Conv2d(ch[-1], 2 * lat, 3, padding=1)
        dec = self.decoder = nn.Module()
        up = ch[::-1]
        dec.conv_in = Conv2d(lat, up[0], 3, padding=1)
        dec.mid_block = _vae_mid(up[0], groups)
        dec.up_blocks = nn.ModuleList()
        for i, out in enumerate(up):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(up[max(i - 1, 0)] if j == 0 else out, out, groups, 1e-6) for j in range(n + 1)])
            blk.upsamplers = nn.ModuleList([Upsample(out)]) if i < len(up) - 1 else None
            dec.up_blocks.append(blk)
        dec.conv_norm_out = GroupNorm(groups, up[-1], 1e-6, True)
        dec.conv_out = Conv2d(up[-1], cfg["out_channels"], 3, padding=1)
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv2d(lat, lat, 1)

    def encode_mean(self, x):
        enc = self.encoder
        x = enc.conv_in(x.float())
        for blk in enc.down_blocks:
            for res in blk.resnets:
                x = res(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
        x = enc.conv_out(enc.conv_norm_out(_run_mid(enc.mid_block, x)))
        return self.quant_conv(x)[:, :self.latent_channels]

    def decode(self, z):
        dec = self.decoder
        x = _run_mid(dec.mid_block, dec.conv_in(self.post_quant_conv(z.float())))
        for blk in dec.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        return dec.conv_out(dec.conv_norm_out(x))


class CLIPAttention(nn.Module):
    prec, recompute = FP32, True

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(dim, dim) for _ in range(4))

    def forward(self, x):
        b, l, d = x.shape
        hd = d // self.heads
        q, k, v = (f(x).view(b, l, self.heads, hd) for f in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attend(self.prec, q, k, v, self.recompute).reshape(b, l, d))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.layer_norm1 = LayerNorm(d, eps=eps)
        self.self_attn = CLIPAttention(d, cfg["num_attention_heads"])
        self.layer_norm2 = LayerNorm(d, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(d, cfg["intermediate_size"])
        self.mlp.fc2 = Linear(cfg["intermediate_size"], d)
        if cfg["hidden_act"] != "quick_gelu":
            raise ValueError(f"unsupported activation {cfg['hidden_act']!r}")

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(h * torch.sigmoid(1.702 * h))


class CLIPVision(nn.Module):
    """transformers' CLIPVisionModelWithProjection (`cfg`: the `image_encoder`
    group): pixels [B, 3, S, S] -> image embeds [B, projection_dim]."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, p, s = cfg["hidden_size"], cfg["patch_size"], cfg["image_size"]
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(d))
        vm.embeddings.patch_embedding = Conv2d(3, d, p, stride=p, bias=False)
        vm.embeddings.position_embedding = nn.Embedding((s // p) ** 2 + 1, d)
        vm.pre_layrnorm = LayerNorm(d, eps=cfg["layer_norm_eps"])
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg["num_hidden_layers"])])
        vm.post_layernorm = LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.visual_projection = Linear(d, cfg["projection_dim"], bias=False)

    def forward(self, pixels):
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixels.float()).flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.float().expand(patches.shape[0], 1, -1), patches], dim=1)
        x = vm.pre_layrnorm(x + emb.position_embedding.weight[None, : x.shape[1]].float())
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def build(kind: str, cfg: dict) -> nn.Module:
    return {"unet": UNet, "vae": VAE, "image_encoder": CLIPVision}[kind](cfg)


def parameter_plan(module: nn.Module) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in `named_parameters` order.
    init: "embedding" (token, position and class embeddings), "fan_in" (every
    other weight of 2+ dims), "bias" (biases and norm shifts), "scale" (norm
    scales)."""
    embeddings = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, nn.Embedding)}
    plan = []
    for name, p in module.named_parameters():
        if name in embeddings or name.endswith(".class_embedding"):
            init = "embedding"
        elif p.ndim >= 2:
            init = "fan_in"
        elif name.endswith("bias"):
            init = "bias"
        else:
            init = "scale"
        plan.append((name, tuple(p.shape), init))
    return plan
