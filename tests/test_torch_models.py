"""Model parity, torch port vs the JAX package, fp32 on the CPU at tiny widths.

Each JAX module's param tree is filled from a seeded numpy rng and carried to
the port's module through the port's converter (`flax_params_to_state_dict`),
then both run the same numpy input. The port is NCHW inside, the JAX package
NHWC: inputs and outputs are transposed at the edges only.

Tolerances: fp32 on both sides, so the differences are summation order in
convolutions, matmuls and reductions (XLA vs ATen). A block stays within
1e-5; whole towers (a dozen+ residual blocks) within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, nchw, nhwc, random_flax_params
from diffusion_e2e_ft_tpu.models import layers as jl
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu_torch.models import layers as tl
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig

TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)


def _rand(shape, seed, loc=0.0):
    return (loc + np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("loc", [0.0, 10.0], ids=["centred", "large-mean"])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_act(loc, silu):
    """The large-mean case exercises the one-pass fp32 moments (E[x^2] - E[x]^2,
    clamped at 0) where their cancellation is largest."""
    x = _rand((2, 6, 5, 16), 0, loc)
    jm = jl.GroupNormAct(4, eps=1e-6, silu=silu)
    p = random_flax_params(jm, 1, x)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = load_into(tl.GroupNormAct(4, 16, eps=1e-6, silu=silu), p)
    # E[x^2] - E[x]^2 at mean 10 cancels ~2 of fp32's 7 digits, and the two
    # frameworks sum in different orders: 1e-4 there, 1e-5 when centred
    _close(nhwc(tm(nchw(x))), want, atol=1e-5 if loc == 0 else 1e-4)


def test_resnet_block():
    x, temb = _rand((2, 6, 5, 8), 2), _rand((2, 24), 3)
    jm = jl.ResnetBlock(16, groups=4)
    p = random_flax_params(jm, 4, x, temb)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(temb)))
    tm = load_into(tl.ResnetBlock(8, 16, groups=4, temb_channels=24), p)
    _close(nhwc(tm(nchw(x), torch.from_numpy(temb))), want, atol=1e-5)


def test_spatial_transformer():
    x, ctx = _rand((2, 4, 6, 32), 5), _rand((2, 2, 24), 6)
    jm = jl.SpatialTransformer(2, 16, groups=8)
    p = random_flax_params(jm, 7, x, ctx)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(ctx)))
    tm = load_into(tl.SpatialTransformer(32, 2, 16, context_dim=24, groups=8), p)
    _close(nhwc(tm(nchw(x), torch.from_numpy(ctx))), want, atol=1e-5)


def test_vae_attention():
    x = _rand((1, 5, 6, 16), 8)
    jm = jl.VAEAttention(16, groups=4)
    p = random_flax_params(jm, 9, x)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = load_into(tl.VAEAttention(16, groups=4), p)
    _close(nhwc(tm(nchw(x))), want, atol=1e-5)


def test_timestep_embedding():
    t = np.asarray([999, 0, 500], np.int32)
    want = np.asarray(jl.timestep_embedding(jnp.asarray(t), 32))
    # sin/cos of arguments up to ~999 rad: the frequencies' last-ulp
    # differences (exp in two libraries) move the result by ~1e-6
    _close(tl.timestep_embedding(torch.from_numpy(t), 32).numpy(), want, atol=1e-5)


@pytest.fixture(scope="module")
def vae_pair():
    jm = JVAE(JVAEConfig(**TINY_VAE))
    p = random_flax_params(jm, 10, jnp.ones((1, 64, 64, 3)))
    return jm, p, load_into(AutoencoderKL(VAEConfig(**TINY_VAE)), p)


def test_vae_encode_mean(vae_pair):
    jm, p, tm = vae_pair
    x = np.tanh(_rand((1, 64, 48, 3), 11))
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), method=jm.encode_mean))
    with torch.inference_mode():
        _close(nhwc(tm.encode_mean(nchw(x))), want, atol=1e-4)


def test_vae_decode(vae_pair):
    jm, p, tm = vae_pair
    z = _rand((1, 8, 6, 4), 12)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(z), method=jm.decode))
    with torch.inference_mode():
        _close(nhwc(tm.decode(nchw(z))), want, atol=1e-4)


@pytest.fixture(scope="module")
def unet_pair():
    jm = JUNet(JUNetConfig.tiny())
    p = random_flax_params(jm, 13, jnp.ones((1, 8, 8, 8)), jnp.asarray(999), jnp.ones((1, 2, 32)))
    return jax.jit(jm.apply), p, load_into(UNet2DCondition(UNetConfig.tiny()), p)


@pytest.mark.parametrize("hw", [(8, 8), (8, 6)], ids=["even", "odd"])
def test_unet(unet_pair, hw):
    """Full tiny UNet at t=999; the 8x6 latent takes the odd-size skip path
    (6 -> 3 -> 2 -> 1 and back up to the skips' sizes)."""
    apply, p, tm = unet_pair
    x, ctx = _rand((1, *hw, 8), 14), _rand((1, 2, 32), 15)
    want = np.asarray(apply({"params": p}, jnp.asarray(x), jnp.asarray(999), jnp.asarray(ctx)))
    with torch.inference_mode():
        got = nhwc(tm(nchw(x), 999, torch.from_numpy(ctx)))
    assert got.shape == (1, *hw, 4)
    _close(got, want, atol=1e-4)
