"""The arithmetic of the reference's products: float32 (the reference) or
float8 e4m3 operands (the control).

Every matrix product and convolution of `reference/models.py` goes through a
`Precision`. `FP32` computes in float32 with TF32 off (set by
`strict_fp32()`), the reference that decides `correct`. `FP8` rounds both
operands of each product to float8 e4m3 with one scale a tensor (amax / 448,
as a per-tensor fp8 GEMM takes them), and the gradients flowing back into
them to e5m2, and accumulates in float32: the step
below the configurations' bfloat16 that a later change might take, so the
control that the comparison has to reject.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def strict_fp32() -> None:
    """float32 products without TF32, on every device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX) -> torch.Tensor:
    """t rounded to a float8 type under one scale (amax / the type's largest value), in float32."""
    t = t.float()
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _FP8Operand(torch.autograd.Function):
    """Forward: the operand rounded to e4m3. Backward: the gradient that flows
    back into it rounded to e5m2, as an fp8 training step keeps its gradients."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t.detach())

    @staticmethod
    def backward(ctx, grad):
        return round_fp8(grad, torch.float8_e5m2, E5M2_MAX)


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    return _FP8Operand.apply(t)


class Precision:
    """float32 products; a subclass rounds the operands first."""

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t.float()

    def linear(self, x, weight, bias=None):
        return F.linear(self.operand(x), self.operand(weight), None if bias is None else bias.float())

    def conv2d(self, x, weight, bias=None, stride=1, padding=0):
        return F.conv2d(self.operand(x), self.operand(weight), None if bias is None else bias.float(),
                        stride=stride, padding=padding)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.operand(a), self.operand(b))


class FP8Operands(Precision):
    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return to_fp8(t)


FP32 = Precision()
FP8 = FP8Operands()
