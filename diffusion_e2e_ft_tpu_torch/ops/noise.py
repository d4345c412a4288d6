"""Initial-latent noise: zeros, gaussian, and multiresolution pyramid noise,
port of `diffusion_e2e_ft_tpu/ops/noise.py`.

Shapes are NCHW, the port's latent layout (the JAX package's are NHWC). The
random modes draw from an explicit `torch.Generator` on the device of the
tensor they make, as the JAX functions take a key: there is no global RNG.

The two packages' random streams differ, so the pyramid is split into a draw
and a compose part. `pyramid_draws` takes the base gaussian and one gaussian
per octave from the generator; `pyramid_compose` is deterministic given them:
each octave upsampled bilinearly (`F.interpolate`, align_corners=False, which
matches `jax.image.resize` when upsampling), weighted `discount**i`, scaled
per sample by t/1000 when a timestep scale is given (every octave but the
base), summed onto the base and divided by the ddof=1 std. The tests hold the
compose part against the JAX function on the JAX draws.

The octave sizes come from scales drawn on the host (`octave_scales`, one
host sync on a CUDA generator): a size is a shape, not a tensor value.

An ensemble draws member by member (`member_draws`): each member's initial
latent is its own [1, C, h, w] draw, as in the JAX pipelines. That matters
for the pyramid, which divides by the std of the whole tensor it made and
draws its octave sizes per call: one batched draw would be another
distribution.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def zeros(shape: Sequence[int], dtype=torch.float32, device=None) -> torch.Tensor:
    """Deterministic zero 'noise': the reference's default and headline configuration."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def gaussian(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def _octave_sizes(height: int, width: int, scales: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    """Per-octave (h, w) targets: octave i uses (dim / r_i**i), floored at 1.

    Stops after the first octave that bottoms out at 1 in either dimension,
    matching the reference's early break."""
    sizes = []
    for i, r in enumerate(scales):
        h = max(1, int(height / (r**i)))
        w = max(1, int(width / (r**i)))
        sizes.append((h, w))
        if h == 1 or w == 1:
            break
    return tuple(sizes)


def octave_scales(generator: torch.Generator, num_octaves: int, base: float, spread: float) -> np.ndarray:
    """Host-side octave scales r ~ U[base, base + spread), from the generator."""
    u = torch.rand(num_octaves, generator=generator, device=generator.device, dtype=torch.float64)
    return u.cpu().numpy() * spread + base


def pyramid_draws(
    generator: torch.Generator, shape: Sequence[int], sizes: Sequence[Tuple[int, int]], dtype=torch.float32
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The base gaussian [B, C, H, W] and one gaussian [B, C, h_i, w_i] per octave."""
    b, c = shape[:2]
    base = gaussian(generator, shape, dtype)
    return base, [gaussian(generator, (b, c, oh, ow), dtype) for oh, ow in sizes]


def pyramid_compose(
    base: torch.Tensor,
    octaves: Sequence[torch.Tensor],
    discount: float = 0.9,
    timestep_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """base + sum_i up(octave_i) * discount**i (* timestep_scale per sample),
    divided by its ddof=1 std (torch's and the reference's `.std()`)."""
    noise = base
    ts = None if timestep_scale is None else torch.as_tensor(timestep_scale).to(base).reshape(-1, 1, 1, 1)
    for i, octave in enumerate(octaves):
        term = F.interpolate(octave, size=base.shape[2:], mode="bilinear", align_corners=False) * (discount**i)
        if ts is not None:
            term = term * ts
        noise = noise + term
    return noise / noise.std()


def pyramid(
    generator: torch.Generator,
    shape: Sequence[int],
    discount: float = 0.9,
    dtype=torch.float32,
    timestep_scale: Optional[torch.Tensor] = None,
    *,
    num_octaves: int = 10,
    base: float = 2.0,
    spread: float = 2.0,
) -> torch.Tensor:
    """Multiresolution pyramid noise over an NCHW latent, normalized to unit std.

    With `timestep_scale=None` this is the training / Marigold variant (octave
    scale r ~ U[2, 4], octave i weighted discount**i). GeoWizard's variant
    passes `timestep_scale = t / 1000` (per sample, [B]) and r ~ U[1.5, 3]."""
    _, _, h, w = shape
    sizes = _octave_sizes(h, w, octave_scales(generator, num_octaves, base, spread))
    noise, octaves = pyramid_draws(generator, shape, sizes, dtype)
    return pyramid_compose(noise, octaves, discount, timestep_scale)


def pyramid_geowizard(
    generator: torch.Generator, shape: Sequence[int], timesteps: torch.Tensor, discount: float = 0.9,
    dtype=torch.float32,
) -> torch.Tensor:
    """GeoWizard's pyramid noise: octaves scaled by t/1000, r ~ U[1.5, 3]."""
    ts = torch.as_tensor(timesteps, device=generator.device).to(dtype) / 1000.0
    return pyramid(generator, shape, discount, dtype, timestep_scale=ts, base=1.5, spread=1.5)


def make_noise(
    noise_type: Optional[str],
    shape: Sequence[int],
    dtype=torch.float32,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dispatch on the reference's noise-type flag values (None treated as zeros).
    The random modes draw on the generator's device."""
    if noise_type is None or noise_type == "zeros":
        return zeros(shape, dtype, device)
    if noise_type in ("gaussian", "pyramid"):
        if generator is None:
            raise ValueError(f"{noise_type} noise requires a torch.Generator")
        if noise_type == "gaussian":
            return gaussian(generator, shape, dtype)
        return pyramid(generator, shape, dtype=dtype)
    raise ValueError(f"Unknown noise type: {noise_type}")


def member_draws(
    noise_type: Optional[str],
    generator: torch.Generator,
    members: int,
    shape: Sequence[int],
    num_step_noises: int = 0,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """An ensemble chunk's draws: the initial latents [members, C, h, w] and
    `num_step_noises` gaussian step noises of that shape (the stochastic
    schedulers' per-step noise).

    Member by member, each draw is [1, C, h, w] in fp32 on the generator's
    device, cast to `dtype`: the member's initial latent, then its step
    noises. So a member's draws do not depend on how the ensemble is cut into
    chunks."""
    one = (1, *shape)
    latents, steps = [], []
    for _ in range(members):
        latents.append(make_noise(noise_type, one, torch.float32, generator.device, generator))
        steps.append([gaussian(generator, one) for _ in range(num_step_noises)])
    step_noise = [torch.cat([s[i] for s in steps]).to(dtype) for i in range(num_step_noises)]
    return torch.cat(latents).to(dtype), step_noise
