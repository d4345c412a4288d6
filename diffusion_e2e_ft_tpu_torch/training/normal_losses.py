"""Generic surface-normal losses for NNET-style baselines, port of
`diffusion_e2e_ft_tpu/training/normal_losses.py`.

DSINE's `projects/baseline_normal/losses.py:12-134`: L1, L2, angular AL,
and the uncertainty-weighted von Mises negative log-likelihood used by
aleatoric-uncertainty normal estimators. Masked statistics are sums over
the valid pixels, divided by their count (at least 1).

Conventions: prediction [..., 3] (+ optional kappa channel [..., 1] for NLL),
target [..., 3] unit normals, mask [...] bool.
"""

from __future__ import annotations

import math

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=1.0)


def _cos(pred: torch.Tensor, target: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.sum(pred * target, dim=-1) / (
        torch.linalg.vector_norm(pred, dim=-1) * torch.linalg.vector_norm(target, dim=-1) + eps
    )


def l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    per_px = torch.sum(torch.abs(pred - target), dim=-1)
    return _masked_mean(per_px, mask)


def l2_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    per_px = torch.sum((pred - target) ** 2, dim=-1)
    return _masked_mean(per_px, mask)


def angular_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """AL: acos of the cosine similarity, mean over valid pixels."""
    angle = torch.arccos(torch.clamp(_cos(pred, target, eps), -1.0 + eps, 1.0 - eps))
    return _masked_mean(angle, mask)


def nll_vonmises(
    pred: torch.Tensor, kappa: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Uncertainty-aware angular NLL with a von Mises-Fisher-style concentration:
    loss = -log(kappa^2 + 1) + kappa * acos(cos) + log(1 + exp(-kappa * pi))."""
    kappa = kappa.squeeze(-1) if kappa.ndim == pred.ndim else kappa
    angle = torch.arccos(torch.clamp(_cos(pred, target, eps), -1.0 + eps, 1.0 - eps))
    nll = -torch.log(torch.square(kappa) + 1.0) + kappa * angle + torch.log1p(torch.exp(-kappa * math.pi))
    return _masked_mean(nll, mask)


LOSS_FUNCS = {
    "l1": l1_loss,
    "l2": l2_loss,
    "al": angular_loss,
    "nll_vonmises": nll_vonmises,
}
