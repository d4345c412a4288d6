"""CLIP text tower (inference only), port of `diffusion_e2e_ft_tpu/models/clip.py`.

The module tree mirrors HF `transformers.CLIPTextModel`
(`text_model.embeddings.*`, `text_model.encoder.layers.N.*`,
`text_model.final_layer_norm`), so a published text-encoder state dict loads
with `strict=True` once its `position_ids` buffer is dropped. The pipeline
runs it once, on the empty prompt, to build the UNet's context.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BOS_TOKEN_ID = 49406
EOS_TOKEN_ID = 49407


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


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(f"Unknown activation: {name}")


def _layer_norm_fp32(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps
    ).to(x.dtype)


class _CLIPAttention(nn.Module):
    """Causal multi-head self-attention over the (short) prompt, plain math."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
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
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.self_attn = _CLIPAttention(c.hidden_size, c.num_heads)
        self.layer_norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.mlp = _CLIPMLP(c.hidden_size, c.intermediate_size, c.hidden_act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(_layer_norm_fp32(self.layer_norm1, x))
        return x + self.mlp(_layer_norm_fp32(self.layer_norm2, x))


class _Embeddings(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Embedding(c.max_position_embeddings, c.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_CLIPLayer(c) for _ in range(c.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, c: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


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
        return F.layer_norm(
            x.float(), tm.final_layer_norm.normalized_shape, tm.final_layer_norm.weight.float(),
            tm.final_layer_norm.bias.float(), tm.final_layer_norm.eps,
        )


def empty_prompt_ids(pad_to: Optional[int] = None) -> np.ndarray:
    """Token ids of the empty prompt: [BOS, EOS], optionally EOS-padded to length."""
    ids = [BOS_TOKEN_ID, EOS_TOKEN_ID]
    if pad_to is not None:
        ids = ids + [EOS_TOKEN_ID] * (pad_to - len(ids))
    return np.asarray([ids], np.int64)
