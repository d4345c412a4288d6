"""First-principles HF state-dict key inventories for the SD2/SD1.5 towers,
the port's own copy of `diffusion_e2e_ft_tpu/tools/hf_key_inventory.py`.

The converter (`models/convert.py`) is a generic rename: a round-trip test cannot
catch a key it silently never produced or consumed. These inventories enumerate the
EXACT diffusers/transformers state-dict layout (names + shapes) from the published
architecture definitions, written out longhand and independent of the converter's
mapping rules, so tests can assert the converter maps *precisely* this set both
ways.

Layout sources (architecture, not code): diffusers `UNet2DConditionModel` /
`AutoencoderKL` as the reference's training script exports them (diffusers 0.30
naming: `to_q`/`to_out.0`, linear projections for SD2's
`use_linear_projection=True`), GeoWizard's vendored UNet variant (SD1.5 conv
projections + a projection class-embedding of the 10-dim switcher), and
transformers' CLIP, generated from `transformers` itself where it is installed
(the CLIP builders import it when called; nothing else here needs it).

Regenerate fixtures: `python -m diffusion_e2e_ft_tpu_torch.tools.hf_key_inventory
--write tests/fixtures/hf_keys`. The committed files are the frozen contract; a
converter or model-topology regression trips the inventory tests, not just
round-trips. Pure Python: `format_inventory`, `parse_inventory` and
`load_fixture` read and write the frozen files.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Dict, Tuple

Shape = Tuple[int, ...]
Inventory = Dict[str, Shape]


# ---------------------------------------------------------------------------
# Shared sub-layouts (diffusers naming)
# ---------------------------------------------------------------------------


def _resnet(prefix: str, in_ch: int, out_ch: int, temb: int | None) -> Inventory:
    """ResnetBlock2D: norm1/conv1/[time_emb_proj]/norm2/conv2/[conv_shortcut]."""
    inv: Inventory = {
        f"{prefix}.norm1.weight": (in_ch,),
        f"{prefix}.norm1.bias": (in_ch,),
        f"{prefix}.conv1.weight": (out_ch, in_ch, 3, 3),
        f"{prefix}.conv1.bias": (out_ch,),
        f"{prefix}.norm2.weight": (out_ch,),
        f"{prefix}.norm2.bias": (out_ch,),
        f"{prefix}.conv2.weight": (out_ch, out_ch, 3, 3),
        f"{prefix}.conv2.bias": (out_ch,),
    }
    if temb is not None:
        inv[f"{prefix}.time_emb_proj.weight"] = (out_ch, temb)
        inv[f"{prefix}.time_emb_proj.bias"] = (out_ch,)
    if in_ch != out_ch:
        inv[f"{prefix}.conv_shortcut.weight"] = (out_ch, in_ch, 1, 1)
        inv[f"{prefix}.conv_shortcut.bias"] = (out_ch,)
    return inv


def _transformer2d(prefix: str, ch: int, cross_dim: int, linear_proj: bool) -> Inventory:
    """Transformer2DModel with one BasicTransformerBlock (SD2/SD1.5 depth=1).

    SD2 (`use_linear_projection=True`) stores proj_in/out as Linear [ch, ch];
    SD1.5/GeoWizard as 1x1 convs [ch, ch, 1, 1]. Attention q/k/v carry no bias;
    out-proj does. Feed-forward is GEGLU: net.0.proj doubles to 8*ch.
    """
    proj_shape = (ch, ch) if linear_proj else (ch, ch, 1, 1)
    inv: Inventory = {
        f"{prefix}.norm.weight": (ch,),
        f"{prefix}.norm.bias": (ch,),
        f"{prefix}.proj_in.weight": proj_shape,
        f"{prefix}.proj_in.bias": (ch,),
        f"{prefix}.proj_out.weight": proj_shape,
        f"{prefix}.proj_out.bias": (ch,),
    }
    tb = f"{prefix}.transformer_blocks.0"
    for norm in ("norm1", "norm2", "norm3"):
        inv[f"{tb}.{norm}.weight"] = (ch,)
        inv[f"{tb}.{norm}.bias"] = (ch,)
    for attn, kv_dim in (("attn1", ch), ("attn2", cross_dim)):
        inv[f"{tb}.{attn}.to_q.weight"] = (ch, ch)
        inv[f"{tb}.{attn}.to_k.weight"] = (ch, kv_dim)
        inv[f"{tb}.{attn}.to_v.weight"] = (ch, kv_dim)
        inv[f"{tb}.{attn}.to_out.0.weight"] = (ch, ch)
        inv[f"{tb}.{attn}.to_out.0.bias"] = (ch,)
    inv[f"{tb}.ff.net.0.proj.weight"] = (8 * ch, ch)
    inv[f"{tb}.ff.net.0.proj.bias"] = (8 * ch,)
    inv[f"{tb}.ff.net.2.weight"] = (ch, 4 * ch)
    inv[f"{tb}.ff.net.2.bias"] = (ch,)
    return inv


def _vae_attention(prefix: str, ch: int) -> Inventory:
    """AutoencoderKL mid attention (single head, modern to_q naming, WITH biases)."""
    inv: Inventory = {
        f"{prefix}.group_norm.weight": (ch,),
        f"{prefix}.group_norm.bias": (ch,),
    }
    for p in ("to_q", "to_k", "to_v", "to_out.0"):
        inv[f"{prefix}.{p}.weight"] = (ch, ch)
        inv[f"{prefix}.{p}.bias"] = (ch,)
    return inv


# ---------------------------------------------------------------------------
# UNet2DConditionModel
# ---------------------------------------------------------------------------


def unet_inventory(
    in_channels: int = 8,
    out_channels: int = 4,
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280),
    layers_per_block: int = 2,
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False),
    cross_attention_dim: int = 1024,
    use_linear_projection: bool = True,
    class_embed_proj_dim: int | None = None,
) -> Inventory:
    c = block_out_channels
    temb = c[0] * 4
    inv: Inventory = {
        "conv_in.weight": (c[0], in_channels, 3, 3),
        "conv_in.bias": (c[0],),
        "time_embedding.linear_1.weight": (temb, c[0]),
        "time_embedding.linear_1.bias": (temb,),
        "time_embedding.linear_2.weight": (temb, temb),
        "time_embedding.linear_2.bias": (temb,),
        "conv_norm_out.weight": (c[0],),
        "conv_norm_out.bias": (c[0],),
        "conv_out.weight": (out_channels, c[0], 3, 3),
        "conv_out.bias": (out_channels,),
    }
    if class_embed_proj_dim is not None:
        # class_embed_type='projection': a TimestepEmbedding over the raw vector
        # (GeoWizard's 10-dim sin/cos switcher)
        inv.update({
            "class_embedding.linear_1.weight": (temb, class_embed_proj_dim),
            "class_embedding.linear_1.bias": (temb,),
            "class_embedding.linear_2.weight": (temb, temb),
            "class_embedding.linear_2.bias": (temb,),
        })

    # down path
    for i, out_ch in enumerate(c):
        in_ch = c[i - 1] if i > 0 else c[0]
        for j in range(layers_per_block):
            rin = in_ch if j == 0 else out_ch
            inv.update(_resnet(f"down_blocks.{i}.resnets.{j}", rin, out_ch, temb))
            if cross_attention_levels[i]:
                inv.update(_transformer2d(
                    f"down_blocks.{i}.attentions.{j}", out_ch,
                    cross_attention_dim, use_linear_projection,
                ))
        if i < len(c) - 1:
            inv[f"down_blocks.{i}.downsamplers.0.conv.weight"] = (out_ch, out_ch, 3, 3)
            inv[f"down_blocks.{i}.downsamplers.0.conv.bias"] = (out_ch,)

    # mid
    mid = c[-1]
    inv.update(_resnet("mid_block.resnets.0", mid, mid, temb))
    inv.update(_transformer2d(
        "mid_block.attentions.0", mid, cross_attention_dim, use_linear_projection
    ))
    inv.update(_resnet("mid_block.resnets.1", mid, mid, temb))

    # up path (diffusers channel bookkeeping: skip widths come from the down path)
    rev = tuple(reversed(c))
    rev_attn = tuple(reversed(cross_attention_levels))
    prev_out = rev[0]
    for i, out_ch in enumerate(rev):
        skip_in = rev[min(i + 1, len(c) - 1)]
        n_res = layers_per_block + 1
        for j in range(n_res):
            res_skip = skip_in if j == n_res - 1 else out_ch
            rin = (prev_out if j == 0 else out_ch) + res_skip
            inv.update(_resnet(f"up_blocks.{i}.resnets.{j}", rin, out_ch, temb))
            if rev_attn[i]:
                inv.update(_transformer2d(
                    f"up_blocks.{i}.attentions.{j}", out_ch,
                    cross_attention_dim, use_linear_projection,
                ))
        if i < len(c) - 1:
            inv[f"up_blocks.{i}.upsamplers.0.conv.weight"] = (out_ch, out_ch, 3, 3)
            inv[f"up_blocks.{i}.upsamplers.0.conv.bias"] = (out_ch,)
        prev_out = out_ch
    return inv


# ---------------------------------------------------------------------------
# AutoencoderKL
# ---------------------------------------------------------------------------


def vae_inventory(
    in_channels: int = 3,
    out_channels: int = 3,
    latent_channels: int = 4,
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512),
    layers_per_block: int = 2,
) -> Inventory:
    c = block_out_channels
    inv: Inventory = {
        "encoder.conv_in.weight": (c[0], in_channels, 3, 3),
        "encoder.conv_in.bias": (c[0],),
        "encoder.conv_norm_out.weight": (c[-1],),
        "encoder.conv_norm_out.bias": (c[-1],),
        "encoder.conv_out.weight": (2 * latent_channels, c[-1], 3, 3),
        "encoder.conv_out.bias": (2 * latent_channels,),
        "quant_conv.weight": (2 * latent_channels, 2 * latent_channels, 1, 1),
        "quant_conv.bias": (2 * latent_channels,),
        "post_quant_conv.weight": (latent_channels, latent_channels, 1, 1),
        "post_quant_conv.bias": (latent_channels,),
        "decoder.conv_in.weight": (c[-1], latent_channels, 3, 3),
        "decoder.conv_in.bias": (c[-1],),
        "decoder.conv_norm_out.weight": (c[0],),
        "decoder.conv_norm_out.bias": (c[0],),
        "decoder.conv_out.weight": (out_channels, c[0], 3, 3),
        "decoder.conv_out.bias": (out_channels,),
    }
    # encoder downs (no time embedding anywhere in the VAE)
    for i, out_ch in enumerate(c):
        in_ch = c[i - 1] if i > 0 else c[0]
        for j in range(layers_per_block):
            rin = in_ch if j == 0 else out_ch
            inv.update(_resnet(f"encoder.down_blocks.{i}.resnets.{j}", rin, out_ch, None))
        if i < len(c) - 1:
            inv[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"] = (out_ch, out_ch, 3, 3)
            inv[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"] = (out_ch,)
    # both mids
    for tower in ("encoder", "decoder"):
        mid = c[-1]
        inv.update(_resnet(f"{tower}.mid_block.resnets.0", mid, mid, None))
        inv.update(_vae_attention(f"{tower}.mid_block.attentions.0", mid))
        inv.update(_resnet(f"{tower}.mid_block.resnets.1", mid, mid, None))
    # decoder ups: plain stacks (no skip concats), layers_per_block+1 resnets
    rev = tuple(reversed(c))
    prev_out = rev[0]
    for i, out_ch in enumerate(rev):
        for j in range(layers_per_block + 1):
            rin = prev_out if j == 0 else out_ch
            inv.update(_resnet(f"decoder.up_blocks.{i}.resnets.{j}", rin, out_ch, None))
        if i < len(rev) - 1:
            inv[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"] = (out_ch, out_ch, 3, 3)
            inv[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"] = (out_ch,)
        prev_out = out_ch
    return inv


# ---------------------------------------------------------------------------
# CLIP (generated from transformers — installed and authoritative)
# ---------------------------------------------------------------------------


def clip_text_inventory() -> Inventory:
    """SD2's OpenCLIP ViT-H text encoder as a transformers CLIPTextModel."""
    import torch
    from transformers import CLIPTextConfig, CLIPTextModel

    cfg = CLIPTextConfig(
        vocab_size=49408, hidden_size=1024, num_hidden_layers=23,
        num_attention_heads=16, intermediate_size=4096,
        max_position_embeddings=77, hidden_act="gelu", projection_dim=512,
    )
    with torch.device("meta"):
        model = CLIPTextModel(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def clip_vision_inventory() -> Inventory:
    """The GeoWizard image encoder (`lambdalabs/sd-image-variations-diffusers`
    layout): CLIP ViT-L/14 vision tower with a 768-dim projection."""
    import torch
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    cfg = CLIPVisionConfig(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
        intermediate_size=4096, image_size=224, patch_size=14,
        projection_dim=768, hidden_act="quick_gelu",
    )
    with torch.device("meta"):
        model = CLIPVisionModelWithProjection(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# Fixture IO
# ---------------------------------------------------------------------------

INVENTORIES = {
    "sd2_unet_8ch": lambda: unet_inventory(in_channels=8),
    "sd2_unet_4ch": lambda: unet_inventory(in_channels=4),
    "sd2_vae": vae_inventory,
    "geowizard_unet": lambda: unet_inventory(
        in_channels=8, cross_attention_dim=768, use_linear_projection=False,
        class_embed_proj_dim=10,
    ),
    "clip_text_sd2": clip_text_inventory,
    "clip_vision_vitl": clip_vision_inventory,
}


def format_inventory(inv: Inventory) -> str:
    lines = [f"{k} {','.join(map(str, shape))}" for k, shape in sorted(inv.items())]
    return "\n".join(lines) + "\n"


def parse_inventory(text: str) -> Inventory:
    inv: Inventory = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, shape = line.split()
        inv[name] = tuple(int(s) for s in shape.split(","))
    return inv


def load_fixture(fixture_dir: str, name: str) -> Inventory:
    with open(os.path.join(fixture_dir, f"{name}.txt")) as f:
        return parse_inventory(f.read())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--write", metavar="DIR", help="write fixture files to DIR")
    args = ap.parse_args()
    for name, fn in INVENTORIES.items():
        inv = fn()
        n_params = sum(math.prod(s) for s in inv.values())
        print(f"{name}: {len(inv)} tensors, {n_params / 1e6:.1f}M params")
        if args.write:
            os.makedirs(args.write, exist_ok=True)
            with open(os.path.join(args.write, f"{name}.txt"), "w") as f:
                f.write(format_inventory(inv))


if __name__ == "__main__":
    main()
