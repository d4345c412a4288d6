"""Global seeding across python, numpy and torch, port of
`diffusion_e2e_ft_tpu/utils/seeding.py` (which returns a JAX root key; the
port returns a `torch.Generator` instead)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_all(seed: int) -> torch.Generator:
    """Seed python's `random`, numpy and torch (`torch.manual_seed` seeds
    every CUDA device too, where there is one) and return a CPU generator
    seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
