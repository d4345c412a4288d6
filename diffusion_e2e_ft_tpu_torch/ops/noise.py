"""Initial-latent noise. Only the deterministic `zeros` mode (the production
configuration) is ported; gaussian and pyramid noise come with multi-step
ensembles."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def zeros(shape: Sequence[int], dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def make_noise(
    noise_type: Optional[str], shape: Sequence[int], dtype=torch.float32, device=None
) -> torch.Tensor:
    """Dispatch on the reference's noise-type flag values (None treated as zeros)."""
    if noise_type is None or noise_type == "zeros":
        return zeros(shape, dtype, device)
    if noise_type in ("gaussian", "pyramid"):
        raise NotImplementedError(
            f"{noise_type} noise is not ported yet (slice C: multi-step, noise, ensembles)"
        )
    raise ValueError(f"Unknown noise type: {noise_type}")
