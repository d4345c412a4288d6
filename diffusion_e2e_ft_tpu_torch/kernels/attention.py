"""Multi-head attention over [B, L, N, D] tensors, dispatched by device and shape.

A CPU tensor takes the plain version. A CUDA tensor inside the kernels'
envelope launches the flash-attention kernels, and raises if it cannot; there
is no fallback. When an input requires grad, the differentiable route runs:
the forward+LSE kernel now and the dq and dk/dv kernels in the backward.
Otherwise (serving, the frozen encoder under `no_grad`) the plain forward
kernel runs. Outside the envelope (cross-attention over the 2- or 77-token
text context, the UNet mid-block's 80-144 tokens) attention is plain matmul
and softmax, as the JAX package leaves those shapes to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

MIN_SEQ = 256


def in_kernel_envelope(lq: int, lk: int, d: int) -> bool:
    """Shape-only predicate: which attention calls the kernels serve.

    The JAX envelope is d <= 512 and Lq >= 256 with a KV block that fits; the
    kernels here take the head dims the main path has (64 and 512)."""
    return d in fa.HEAD_DIMS and lq >= MIN_SEQ and lk >= MIN_SEQ


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D] (self or cross attention)."""
    if q.device.type == "cuda" and in_kernel_envelope(q.shape[1], k.shape[1], q.shape[-1]):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return fa.flash_attention_autograd(q, k, v, scale)
        return fa.flash_attention(q, k, v, scale)
    return fa.flash_attention_reference(q, k, v, scale)
