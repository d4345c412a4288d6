"""CLIP text and vision towers (inference only), port of
`diffusion_e2e_ft_tpu/models/clip.py`.

The module trees mirror HF `transformers.CLIPTextModel`
(`text_model.embeddings.*`, `text_model.encoder.layers.N.*`,
`text_model.final_layer_norm`) and `CLIPVisionModelWithProjection`
(`vision_model.embeddings.{class_embedding, patch_embedding,
position_embedding}`, `vision_model.pre_layrnorm`, `vision_model.encoder.*`,
`vision_model.post_layernorm`, `visual_projection`), so a published state dict
loads with `strict=True` once its `position_ids` buffer is dropped. The Marigold
pipeline runs the text tower once, on the empty prompt, to build the UNet's
context; GeoWizard runs the vision tower on every image (ViT-L/14 with a
768-dim projection, the `lambdalabs/sd-image-variations-diffusers` image
encoder). Attention inside both towers is plain math: 77 or 257 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusion_e2e_ft_tpu_torch.models.layers import LayerNormFP32
from diffusion_e2e_ft_tpu_torch.utils import trace

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407

# CLIP image preprocessing constants (224x224 bicubic + normalize)
CLIP_IMAGE_SIZE = 224
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    num_layers: int = 23
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 77
    hidden_act: str = "gelu"  # SD2/OpenCLIP-H: gelu; SD1.5/CLIP-L: quick_gelu
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(f"Unknown activation: {name}")


class _CLIPAttention(nn.Module):
    """Multi-head self-attention over the prompt (causal) or the image patches,
    plain math."""

    def __init__(self, dim: int, num_heads: int, causal: bool):
        super().__init__()
        self.num_heads, self.causal = num_heads, causal
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        hd = d // h
        q = (self.q_proj(x) * hd**-0.5).view(b, l, h, hd)
        k = self.k_proj(x).view(b, l, h, hd)
        v = self.v_proj(x).view(b, l, h, hd)
        logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        if self.causal:
            causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~causal, -1e9)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, l, d)
        return self.out_proj(out)


class _CLIPMLP(nn.Module):
    def __init__(self, dim: int, intermediate: int, hidden_act: str):
        super().__init__()
        self.hidden_act = hidden_act
        self.fc1 = nn.Linear(dim, intermediate)
        self.fc2 = nn.Linear(intermediate, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_act(self.hidden_act, self.fc1(x)))


class _CLIPLayer(nn.Module):
    def __init__(self, c, causal: bool = True):
        super().__init__()
        self.layer_norm1 = LayerNormFP32(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attn = _CLIPAttention(c.hidden_size, c.num_heads, causal)
        self.layer_norm2 = LayerNormFP32(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = _CLIPMLP(c.hidden_size, c.intermediate_size, c.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_position_embeddings, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c, causal: bool = True):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(c, causal) for _ in range(c.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = LayerNormFP32(c.hidden_size, eps=c.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """input ids [B, L] -> last hidden state [B, L, D] (after final_layer_norm, fp32)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        l = input_ids.shape[1]
        pos = torch.arange(l, device=input_ids.device)[None]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x.float())


class _VisionEmbeddings(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(c.hidden_size))
        self.patch_embedding = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size, bias=False)
        self.position_embedding = nn.Embedding((c.image_size // c.patch_size) ** 2 + 1, c.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, c: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(c)
        self.pre_layrnorm = LayerNormFP32(c.hidden_size, eps=c.layer_norm_eps)  # (sic), the HF name
        self.encoder = _Encoder(c, causal=False)
        self.post_layernorm = LayerNormFP32(c.hidden_size, eps=c.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    """CLIP-normalized pixels [B, 3, S, S] (S = image_size) -> projected image
    embeds [B, projection_dim], in the module's dtype."""

    def __init__(self, config: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    @trace.traced("image_encoder")
    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        patches = emb.patch_embedding(pixel_values.to(emb.patch_embedding.weight.dtype))
        b = patches.shape[0]
        patches = patches.flatten(2).transpose(1, 2)  # [B, P, D], row-major patches as the JAX reshape
        cls = emb.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        x = x + emb.position_embedding(torch.arange(x.shape[1], device=x.device))[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        return self.visual_projection(pooled)


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] -> CLIP pixels [B, 3, 224, 224]: bicubic resize
    (antialiased, which matches the JAX "cubic" resize; without antialias
    torch's a = -0.75 kernel differs from JAX's a = -0.5) and the CLIP mean
    and std, in fp32."""
    x = images.float().permute(0, 3, 1, 2)
    size = (CLIP_IMAGE_SIZE, CLIP_IMAGE_SIZE)
    x = F.interpolate(x, size=size, mode="bicubic", antialias=True, align_corners=False)
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def empty_prompt_ids(pad_to: Optional[int] = None) -> np.ndarray:
    """Token ids of the empty prompt: [BOS, EOS], optionally EOS-padded to length."""
    ids = [BOS_TOKEN_ID, EOS_TOKEN_ID]
    if pad_to is not None:
        ids = ids + [EOS_TOKEN_ID] * (pad_to - len(ids))
    return np.asarray([ids], np.int64)
