"""Ensembling of affine-invariant depth maps and unit normal fields, port of
`diffusion_e2e_ft_tpu/ops/ensemble.py`.

Depth: every member gets a scale and shift, found by scipy's BFGS (numerical
gradients, on the host) over a pairwise-RMS + near/far regulariser objective
that runs on the predictions' own device in float32; the aligned members are
then reduced (lower median and MAD, or mean and ddof=1 std) and min-max
scaled. `ensemble_depths` is `align_depths` (the BFGS) followed by
`combine_depths` (the reduction), which the tests hold apart.

The objective is float32, as in the JAX package and the reference, and
scipy's finite-difference steps are of the order of its rounding: two
implementations of the same objective take BFGS to different (s, t). The
aligned result is therefore reproducible within a drift, not to the last bit
(tests/test_torch_ensemble.py states the bound).

Normals: the member closest to the mean spherical direction, not the mean
itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _median_lower(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """torch.median semantics: the lower middle value for an even count."""
    return x.median(dim=dim).values


def _depth_objective(
    images: torch.Tensor, s: torch.Tensor, t: torch.Tensor, reduction: str = "median",
    regularizer_strength: float = 0.02,
) -> torch.Tensor:
    """Pairwise-RMS + near/far regulariser objective for N aligned depth maps [N, H, W] (float32)."""
    n = images.shape[0]
    aligned = images * s.reshape(-1, 1, 1) + t.reshape(-1, 1, 1)
    ii, jj = (torch.as_tensor(i, device=images.device) for i in np.triu_indices(n, k=1))
    sqrt_dist = (aligned[ii] - aligned[jj]).square().mean().sqrt()
    pred = aligned.mean(dim=0) if reduction == "mean" else _median_lower(aligned, dim=0)
    near_err = (0.0 - pred.min()).abs()
    far_err = (1.0 - pred.max()).abs()
    return sqrt_dist + (near_err + far_err) * regularizer_strength


def align_depths(
    images: torch.Tensor,
    regularizer_strength: float = 0.02,
    max_iter: int = 2,
    tol: float = 1e-3,
    reduction: str = "median",
    max_res: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-member (scale, shift), float64 [N] each, by BFGS over the objective
    on `images` [N, H, W] (downsampled so the longer side is at most
    `max_res`, nearest with half-pixel centres, as `jax.image.resize`)."""
    from scipy.optimize import minimize

    images = images.float()
    n = images.shape[0]
    if max_res is not None:
        h, w = images.shape[-2:]
        scale = min(max_res / h, max_res / w)
        if scale < 1:
            images = F.interpolate(images[None], size=(int(h * scale), int(w * scale)), mode="nearest-exact")[0]

    flat = images.reshape(n, -1)
    _min, _max = flat.amin(dim=1).cpu().numpy(), flat.amax(dim=1).cpu().numpy()
    s_init = 1.0 / np.maximum(_max - _min, 1e-8)
    t_init = -s_init * _min
    x0 = np.concatenate([s_init, t_init]).astype(np.float32)

    def closure(x):
        st = torch.as_tensor(np.asarray(x, np.float32), device=images.device)
        return np.float32(_depth_objective(images, st[:n], st[n:], reduction, regularizer_strength).item())

    res = minimize(closure, x0, method="BFGS", tol=tol, options={"maxiter": max_iter, "disp": False})
    return res.x[:n], res.x[n:]


def combine_depths(
    images: torch.Tensor, s, t, reduction: str = "median"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align [N, H, W] by (s, t) in float32 and reduce: (depth [H, W] min-max
    scaled to [0, 1], uncertainty [H, W] on the same scale)."""
    images = images.float()
    s = torch.as_tensor(np.asarray(s, np.float32), device=images.device)
    t = torch.as_tensor(np.asarray(t, np.float32), device=images.device)
    aligned = images * s.reshape(-1, 1, 1) + t.reshape(-1, 1, 1)
    if reduction == "mean":
        combined, uncertainty = aligned.mean(dim=0), aligned.std(dim=0)
    else:
        combined = _median_lower(aligned, dim=0)
        uncertainty = _median_lower((aligned - combined).abs(), dim=0)  # MAD
    lo, hi = combined.min(), combined.max()
    return (combined - lo) / (hi - lo), uncertainty / (hi - lo)


def ensemble_depths(
    input_images: torch.Tensor,
    regularizer_strength: float = 0.02,
    max_iter: int = 2,
    tol: float = 1e-3,
    reduction: str = "median",
    max_res: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Align N affine-invariant depth maps [N, H, W] by a joint (scale, shift)
    BFGS, then reduce: ([H, W] in [0, 1], per-pixel uncertainty), on the
    input's device."""
    images = torch.as_tensor(input_images).float()
    if images.shape[0] == 1:
        d = images[0]
        return (d - d.min()) / (d.max() - d.min()).clamp_min(1e-8), torch.zeros_like(d)
    s, t = align_depths(images, regularizer_strength, max_iter, tol, reduction, max_res)
    return combine_depths(images, s, t, reduction)


def ensemble_normals(input_images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] normal fields -> the member [H, W, 3] (unit-normalised)
    with the smallest total angular error to the mean spherical direction
    (built from the averaged azimuth and polar angles)."""
    n = input_images / (input_images.norm(dim=-1, keepdim=True) + 1e-5)
    phi = torch.atan2(n[..., 1], n[..., 0]).mean(dim=0)
    theta = torch.atan2(n[..., :2].norm(dim=-1), n[..., 2]).mean(dim=0)
    mean_field = torch.stack(
        [theta.sin() * phi.cos(), theta.sin() * phi.sin(), theta.cos()], dim=-1
    )
    cos = (mean_field[None] * n).sum(dim=-1) / (mean_field.norm(dim=-1)[None] * n.norm(dim=-1) + 1e-8)
    err = cos.clamp(-0.999, 0.999).arccos()
    return n[err.reshape(err.shape[0], -1).sum(dim=-1).argmin()]
