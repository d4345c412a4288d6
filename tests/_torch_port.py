"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

JAX param trees come from the JAX module's own `init` signature
(`jax.eval_shape`, no compute) and are filled from `np.random.default_rng`:
kernels lecun-scaled, biases and norm scales perturbed away from 0 / 1 so a
mis-mapped bias or scale shows up. The port receives the same numbers through
its own converter.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from diffusion_e2e_ft_tpu_torch.models import convert as tconvert


def random_flax_params(module, seed: int, *init_args):
    """Param tree of `module` (numpy leaves) filled from a seeded numpy rng."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *init_args)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "embedding":
            return (0.02 * rng.standard_normal(shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_into(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a JAX param tree into a port module through the port's converter."""
    sd = {k: torch.from_numpy(v) for k, v in tconvert.flax_params_to_state_dict(flax_params).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)
