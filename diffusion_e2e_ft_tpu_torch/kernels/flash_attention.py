"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

`flash_attention` launches `csrc/flash_attention.cu`, which replaces the TPU
kernel `diffusion_e2e_ft_tpu/kernels/flash_attention.py::_flash_kernel`
(launched there by `_flash_bnld`). On the H100 the kernel is compute-bound at
the main path's long sequences (about 2 * 2 * L^2 * d FLOPs per head against
O(L * d) bytes); see the source's header note for its design.

`flash_attention_reference` is the same function in plain PyTorch, mirroring
the JAX package's `_xla_attention`: fp32 logits and softmax, probabilities
cast to the value dtype, output in the input dtype. The CPU path and the
kernel's tests use it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

# head dims the kernel is instantiated for (UNet d=64, VAE mid-block d=512)
HEAD_DIMS = (64, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

# Kernel launches since the last `reset_launches()`; compared in the smoke run
# against the number of attention sites the main path should send here.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D] in plain PyTorch."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    probs = torch.softmax(logits * s, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel needs a CUDA tensor")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel takes float32 or bfloat16")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must have a contiguous head dim")
        align = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % align for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise TypeError("flash_attention: q, k, v must share dtype and device")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be [B, L, N, D], got {tuple(q.shape)}")
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} is not one of {HEAD_DIMS}")
    if k.shape != (b, lk, n, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree"
        )
    if lq < 1 or lk < 1 or b * n > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: unsupported sizes B*N={b * n}, Lq={lq}, Lk={lk}")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D] with the CUDA kernel.

    Takes CUDA tensors only; raises on anything the kernel does not take."""
    global launches
    from diffusion_e2e_ft_tpu_torch.kernels import _build

    _check(q, k, v)
    b, lq, n, d = q.shape
    lk = k.shape[1]
    s = float(scale if scale is not None else d**-0.5)
    out = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *(st for t in (q, k, v, out) for st in (t.stride(0), t.stride(1), t.stride(2)))
    )
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.e2eft_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            b, n, lq, lk, d, s, strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {err}) at {tuple(q.shape)} {q.dtype}")
    launches += 1
    return out
