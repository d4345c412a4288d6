"""Flash attention: the Hopper kernels' wrappers, their plain versions, and the
autograd Function that ties the forward to the backward kernels.

Kernels (CUDA C++ for sm_90a, see the sources' header notes for their design):

- `flash_attention` launches `csrc/flash_attention.cu`, which replaces the TPU
  kernel `diffusion_e2e_ft_tpu/kernels/flash_attention.py::_flash_kernel`.
- `flash_attention_mh` launches the same kernel with `hp` heads per block,
  replacing `::_flash_kernel_mh` (the `E2EFT_FA_HP` option at d < 64);
  `heads_per_cta` is the selection rule, read at each call.
- `flash_attention_fwd_lse` launches the same kernel with its LSE flag set,
  replacing `::_flash_kernel_lse`: the output plus the fp32 per-row
  log-sum-exp that the backward needs.
- `flash_attention_bwd` launches `csrc/flash_attention_bwd.cu`'s two kernels,
  replacing `::_dq_kernel` and `::_dkv_kernel`. Their bf16 body keeps S, dP,
  P, ds and the accumulators in registers and streams its operand tiles
  through a `cp.async` ring; `BWD_TILES` mirrors its tiles.

On the H100 all of them are compute-bound at the main path's long sequences
(O(L^2 d) FLOPs per head against O(L d) bytes).

Each has a plain PyTorch version beside it (`*_reference`), with fp32 logits
and softmax as the JAX package's `_xla_attention`. The CPU path and the tests
use those; nothing on the CUDA path does.

`FlashAttentionFunction` mirrors the JAX package's `_flash_btnh` custom_vjp:
the forward saves (q, k, v, out, lse), the backward computes
delta = rowsum(dO * O) in plain torch and runs dq and dk/dv. It takes its two
implementations as an argument (`KERNELS` or `PLAIN`), so the CPU tests run
the same wiring with the plain versions.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from diffusion_e2e_ft_tpu_torch.kernels import _build

# Head dims the kernels are instantiated for: the SD2 UNet (64), the VAE mid
# block (512) and GeoWizard's SD1.5 UNet (40, 80, 160). The differentiable
# route (forward+LSE, dq, dk/dv) takes every one of them.
HEAD_DIMS = (40, 64, 80, 160, 512)
GRAD_HEAD_DIMS = HEAD_DIMS
# the heads-per-block forward: narrow heads only, as the JAX picker (d < 64)
MH_HEAD_DIMS = (40,)
MH_HEADS = (2, 4, 8)
# The bf16 forward's tiles per head dim, as `Tile<D>` in csrc/flash_attention.cu:
# (Q rows per block, KV rows per stage, warps splitting d)
BF16_TILES = {40: (128, 64, 1), 64: (128, 64, 1), 80: (128, 64, 1), 160: (64, 64, 1), 512: (64, 32, 2)}
# The bf16 backward's tiles per head dim and kernel, as `BwdTile<D, kDkv>` in
# csrc/flash_attention_bwd.cu: (rows a block owns, rows a streamed tile, warps
# splitting d). The dq block owns Q rows and streams K / V; the dk/dv block
# owns K / V rows and streams Q / dO.
BWD_TILES = {
    40: {"dq": (64, 64, 1), "dkv": (64, 32, 1)},
    64: {"dq": (64, 64, 1), "dkv": (64, 64, 1)},
    80: {"dq": (64, 32, 1), "dkv": (64, 32, 1)},
    160: {"dq": (64, 32, 1), "dkv": (64, 32, 2)},
    512: {"dq": (64, 16, 2), "dkv": (32, 16, 4)},
}
MH_TILE = BF16_TILES[40][:2]  # (Q, KV) tile rows of the d=40 kernel
_MAX_GRID_Y = 65535

# Kernel launches since the last `reset_launches()`, one count per kernel;
# compared in the smoke run against the attention sites the main path sends
# to each kernel.
launches = {
    "flash_attention_fwd": 0,
    "flash_attention_fwd_mh": 0,
    "flash_attention_fwd_lse": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkv": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(scale if scale is not None else q.shape[-1] ** -0.5)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D] in plain PyTorch."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
    probs = torch.softmax(logits * _scale(q, scale), dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)


def flash_attention_fwd_lse_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_reference` plus the fp32 log-sum-exp of each row of the
    scaled logits, as [B, Lq, N]."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * _scale(q, scale)
    out = torch.einsum("bnqk,bknd->bqnd", torch.softmax(logits, dim=-1).to(v.dtype), v)
    return out, torch.logsumexp(logits, dim=-1).transpose(1, 2)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in plain PyTorch with the kernels' FA-2 math, all in fp32:
    p = exp(s - lse), dv = p^T dO, ds = p (dO V^T - delta) scale, dq = ds K,
    dk = ds^T Q, with delta = rowsum(dO * O). Gradients in the input dtypes."""
    s = _scale(q, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * out.float()).sum(-1).transpose(1, 2)[..., None]  # [B, N, Lq, 1]
    p = torch.exp(torch.einsum("bqnd,bknd->bnqk", qf, kf) * s - lse.transpose(1, 2)[..., None])
    ds = p * (torch.einsum("bqnd,bknd->bnqk", dof, vf) - delta) * s
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qf)
    dv = torch.einsum("bnqk,bqnd->bknd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} is on {t.device}, the kernel needs a CUDA tensor")
    if t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel takes float32 or bfloat16")
    if t.dtype != dtype or t.device != device:
        raise TypeError("flash_attention: q, k, v (and dO) must share dtype and device")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must have a contiguous head dim")
    align = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % align for st in t.stride()[:3]):
        raise ValueError(f"flash_attention: {name} rows must be 16-byte aligned")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dims=HEAD_DIMS) -> None:
    _check_shapes(q, k, v, head_dims)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.dtype, q.device)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dims=HEAD_DIMS) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be [B, L, N, D], got {tuple(q.shape)}")
    b, lq, n, d = q.shape
    lk = k.shape[1]
    if d not in head_dims:
        raise ValueError(f"flash_attention: head dim {d} is not one of {head_dims}")
    if k.shape != (b, lk, n, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree"
        )
    if lq < 1 or lk < 1 or b * n > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: unsupported sizes B*N={b * n}, Lq={lq}, Lk={lk}")


def _strides(*tensors: torch.Tensor):
    """The (b, l, n) element strides of each [B, L, N, D] tensor, as a C array."""
    values = [st for t in tensors for st in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_int64 * len(values))(*values)


def _forward(q, k, v, scale, with_lse: bool):
    _check(q, k, v)
    b, lq, n, d = q.shape
    out = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, lq, n), dtype=torch.float32, device=q.device) if with_lse else None
    # both variants are one C entry point; a null lse selects the plain forward
    _build.launch(
        launches, "flash_attention_fwd_lse" if with_lse else "flash_attention_fwd", q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
        _build.DTYPE_CODES[q.dtype], b, n, lq, k.shape[1], d, _scale(q, scale), _strides(q, k, v, out),
        entry="flash_attention_fwd",
    )
    return out, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """[B, Lq, N, D] x [B, Lk, N, D] -> [B, Lq, N, D] with the CUDA kernel.

    Takes CUDA tensors only; raises on anything the kernel does not take."""
    return _forward(q, k, v, scale, with_lse=False)[0]


def heads_per_cta(bn: int, lq: int, lk: int, d: int) -> int:
    """Heads per block for the forward, from `E2EFT_FA_HP` (default 1), read
    at each call. As the JAX `_pick_heads_per_program` without its VMEM term:
    hp > 1 only for narrow heads, when B*N divides by hp and Lq and Lk are each
    at least one tile (`MH_TILE`: the Q tile and the KV tile); any other value
    (or an hp the kernel is not built for) gives 1, the one-head kernel."""
    hp = int(os.environ.get("E2EFT_FA_HP", "1"))
    if hp not in MH_HEADS or d not in MH_HEAD_DIMS or bn % hp or lq < MH_TILE[0] or lk < MH_TILE[1]:
        return 1
    return hp


def flash_attention_mh(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float], hp: int
) -> torch.Tensor:
    """`flash_attention` with `hp` consecutive (batch, head) pairs per block
    (d = 40, hp in 2, 4, 8, B*N divisible by hp). CUDA tensors only."""
    _check(q, k, v, MH_HEAD_DIMS)
    b, lq, n, d = q.shape
    if hp not in MH_HEADS or (b * n) % hp:
        raise ValueError(f"flash_attention_mh: hp={hp} must be one of {MH_HEADS} and divide B*N={b * n}")
    out = torch.empty((b, lq, n, d), dtype=q.dtype, device=q.device)
    _build.launch(
        launches, "flash_attention_fwd_mh", q, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, n, lq, k.shape[1], d, hp, _scale(q, scale), _strides(q, k, v, out),
    )
    return out


def flash_attention_fwd_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Lq, N, D], lse [B, Lq, N] fp32) with the CUDA kernel."""
    return _forward(q, k, v, scale, with_lse=True)


def _bwd_launch(name, q, k, v, do, lse, delta, scale, outs):
    """Check the backward's operands and launch kernel `name`, which writes `outs`."""
    _check(q, k, v)
    _check_operand("dO", do, q.dtype, q.device)
    b, lq, n, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for label, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, lq, n) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {label} must be contiguous fp32 [{b}, {lq}, {n}]")
    # the C entry points take all seven stride triples; dq or dk/dv are placeholders where unused
    dq, dk, dv = (outs[0], q, k) if len(outs) == 1 else (q, *outs)
    _build.launch(
        launches, name, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs), _build.DTYPE_CODES[q.dtype], b, n, lq,
        k.shape[1], d, _scale(q, scale), _strides(q, k, v, do, dq, dk, dv),
    )


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale: Optional[float] = None) -> torch.Tensor:
    """dq [B, Lq, N, D] with the dq kernel; lse and delta are fp32 [B, Lq, N]."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, do, lse, delta, scale, (dq,))
    return dq


def flash_attention_bwd_dkv(
    q, k, v, do, lse, delta, scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Lk, N, D] with the dk/dv kernel; lse and delta are fp32 [B, Lq, N]."""
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_attention_bwd_dkv", q, k, v, do, lse, delta, scale, (dk, dv))
    return dk, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) with the dq and dk/dv CUDA kernels. `do` is the gradient
    of `out`; `out` and `lse` come from `flash_attention_fwd_lse`."""
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} != q {tuple(q.shape)}")
    # delta = rowsum(dO * O) in fp32, outside the kernels, as the JAX package leaves it to XLA
    delta = (do.float() * out.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


class FlashImpl(NamedTuple):
    """The two halves the autograd Function runs."""

    fwd_lse: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    bwd: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


KERNELS = FlashImpl(flash_attention_fwd_lse, flash_attention_bwd)
PLAIN = FlashImpl(flash_attention_fwd_lse_reference, flash_attention_bwd_reference)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable attention over [B, L, N, D]: forward+LSE, then dq / dk / dv.

    Under autocast the projections arrive in the autocast dtype; the
    custom_fwd / custom_bwd decorators run the backward under the forward's
    autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale: float, impl: FlashImpl):
        out, lse = impl.fwd_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.impl = scale, impl
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand a non-contiguous cotangent; the kernels take rows
        dq, dk, dv = ctx.impl.bwd(q, k, v, grad_out.contiguous(), out, lse, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_autograd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None,
    impl: FlashImpl = KERNELS,
) -> torch.Tensor:
    """Differentiable [B, Lq, N, D] attention through `impl` (kernels by default)."""
    return FlashAttentionFunction.apply(q, k, v, _scale(q, scale), impl)
