"""Seeded weights, made on the device in a few large draws.

One module's weights come from one `torch.randn` over all of its random
leaves, drawn in the dtype they are served in from a generator on the
device, seeded from (seed, module): weights of fan-in scale (lecun normal)
for matrices and kernels, N(0, 0.02) for embeddings, N(0, 0.1) for every
bias (norm shifts included) and 1 + N(0, 0.1) for norm scales, so that a
kernel that drops or misapplies a bias or a norm's affine changes the
answers. The same seed gives the same tensors on every call, so the
reference draws them again after the window instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

AFFINE_STD = 0.1  # of biases and of norm scales around 1
MODULE_STREAMS = {"unet": 1, "vae": 2, "image_encoder": 3, "text_context": 4, "inputs": 5}


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of one run, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) % (1 << 64), stream]).generate_state(1, np.uint64)[0] >> 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def make_state(plan: Iterable[Tuple[str, Tuple[int, ...], str]], seed: int, stream: int, device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for a `reference.models.parameter_plan`."""
    plan = list(plan)
    total = sum(int(np.prod(s)) for _, s, _ in plan)
    flat = torch.randn(total, generator=generator(seed, stream, device), device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape, init in plan:
        n = int(np.prod(shape))
        std = {"embedding": 0.02, "bias": AFFINE_STD, "scale": AFFINE_STD}.get(init)
        draw = flat[offset:offset + n].view(shape) * (float(np.prod(shape[1:])) ** -0.5 if std is None else std)
        out[name] = draw + 1 if init == "scale" else draw
        offset += n
    return out


def normal(shape, seed: int, stream: int, device, dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator(seed, stream, device), device=device, dtype=dtype)
