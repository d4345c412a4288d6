"""Peaks of one H100 and the least time a piece of work could take on it.

Published peaks of an NVIDIA H100 SXM (dense, without sparsity): 989 TFLOP/s
in bfloat16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35
TB/s of HBM3. `roofline` is the larger of the operations over their peak and
the bytes over the HBM rate. `attention_fwd` and `attention_bwd` count a
call's products from its shapes, with Lq and Lk apart (cross-attention,
joint attention): the forward 2 products (S = Q K^T, O = P V), the backward
3 for dq (S again, dP = dO V^T, dQ = dS K) and 4 for dk, dv (S, dP, dV =
P^T dO, dK = dS^T Q), each 2 Lq Lk d operations a head.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def roofline_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def attention_fwd(b: int, lq: int, lk: int, heads: int, d: int, itemsize: int = 2):
    """(flops, bytes) of one forward: Q, O of [B, Lq, N, d], K, V of [B, Lk, N, d]."""
    flops = 2 * 2.0 * b * heads * lq * lk * d
    nbytes = itemsize * b * heads * d * (2 * lq + 2 * lk)
    return flops, nbytes


def attention_bwd(b: int, lq: int, lk: int, heads: int, d: int, itemsize: int = 2):
    """(flops, bytes) of one backward (dq, dk, dv): Q, O, dO, dQ of [B, Lq, N, d],
    K, V, dK, dV of [B, Lk, N, d], the fp32 log-sum-exp and delta of [B, Lq, N]."""
    flops = (3 + 4) * 2.0 * b * heads * lq * lk * d
    nbytes = itemsize * b * heads * d * (4 * lq + 4 * lk) + 2 * 4 * b * heads * lq
    return flops, nbytes


def group_norm_bytes(numel: int, itemsize: int = 2) -> float:
    """A standalone GroupNorm reads x once and writes y once."""
    return 2.0 * numel * itemsize


def conv3x3_flops(b: int, cin: int, cout: int, h: int, w: int) -> float:
    return 2.0 * b * cout * cin * 9 * h * w
