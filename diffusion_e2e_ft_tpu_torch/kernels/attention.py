"""Multi-head attention over [B, L, N, D] tensors, dispatched by device and shape,
and GeoWizard's joint cross-task attention.

A CPU tensor takes the plain version. A CUDA tensor inside the kernels'
envelope launches the flash-attention kernels, and raises if it cannot; there
is no fallback. The envelope is head dims 40, 64, 80, 160 and 512 (the SD2
models' and GeoWizard's) and sequences of at least `MIN_SEQ`; inside it a call
takes one of two routes:

- the forward route (no input requires grad: serving, the frozen encoder
  under `no_grad`), with `E2EFT_FA_HP` selecting the heads-per-block kernel
  at d = 40;
- the differentiable route (forward+LSE now, dq and dk/dv in the backward)
  when an input requires grad.

Outside the envelope (cross-attention over the 1-, 2- or 77-token context,
the UNet mid-block's 80-216 tokens) attention is plain matmul and softmax, as
the JAX package leaves those shapes to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa

MIN_SEQ = 256


def in_kernel_envelope(lq: int, lk: int, d: int) -> bool:
    """Shape-only predicate: which attention calls the kernels serve.

    The JAX envelope is d <= 512 and Lq >= 256 with a KV block that fits; the
    kernels here take the head dims the ported models have."""
    return d in fa.HEAD_DIMS and lq >= MIN_SEQ and lk >= MIN_SEQ


def cuda_route(lq: int, lk: int, d: int, needs_grad: bool) -> str:
    """Which implementation a CUDA call takes: "plain", "forward" or "autograd"."""
    if not in_kernel_envelope(lq, lk, d):
        return "plain"
    return "autograd" if needs_grad else "forward"


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D] (self or cross attention)."""
    if q.device.type != "cuda":
        return fa.flash_attention_reference(q, k, v, scale)
    b, lq, n, d = q.shape
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    route = cuda_route(lq, k.shape[1], d, needs_grad)
    if route == "autograd":
        return fa.flash_attention_autograd(q, k, v, scale)
    if route == "forward":
        hp = fa.heads_per_cta(b * n, lq, k.shape[1], d)
        if hp > 1:
            return fa.flash_attention_mh(q, k, v, scale, hp)
        return fa.flash_attention(q, k, v, scale)
    return fa.flash_attention_reference(q, k, v, scale)


def joint_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Cross-task joint self-attention for a [2B, L, N, D] task-paired batch.

    The batch is [depth half; normal half]. Each half's queries attend over
    both halves' keys and values, which is plain self-attention over the
    sequence-concatenated [B, 2L] batch (as the JAX `joint_attention`): one
    call at 2L tokens."""
    two_b, length, n, d = q.shape
    b = two_b // 2

    def pair(t: torch.Tensor) -> torch.Tensor:  # [2B, L, N, D] -> [B, 2L, N, D]
        return t.reshape(2, b, length, n, d).transpose(0, 1).reshape(b, 2 * length, n, d)

    out = attention(pair(q), pair(k), pair(v), scale=scale)
    return out.reshape(b, 2, length, n, d).transpose(0, 1).reshape(two_b, length, n, d)
