"""The torch port's noise (`ops/noise.py`) and the trainers' noise latents
against the JAX package, fp32 on the CPU.

The two packages' random streams differ, so the parity tests regenerate the
JAX draws from the JAX key (`jax.random`, in the JAX functions' order) and
feed them to the port's deterministic compose part; what the port draws from
its `torch.Generator` is held to its statistics (ddof=1 unit std) and to
determinism in the generator. The octave sizes come from the JAX trainers'
16-row schedule bank, which both packages draw from `config.seed` with numpy:
equal row for row. Tolerance of the compose part: 1e-5 (fp32 bilinear
weights and the std's summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.ops import noise as jnoise
from diffusion_e2e_ft_tpu.training import E2ETrainer as JTrainer, GeoWizardTrainer as JGeoTrainer
from diffusion_e2e_ft_tpu.training import TrainConfig as JConfig
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.ops import noise as tnoise
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
from diffusion_e2e_ft_tpu_torch.training.trainer import pyramid_scale_bank

UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
LATENT_HW = [(60, 80), (6, 8), (96, 96), (1, 7)]  # 480x640, the tests' 48x64, a square one, one row


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.array(x), -1, 1)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.numpy(), 1, -1)


def jax_trainer(geowizard: bool, seed: int, **cfg):
    """A JAX trainer built with empty frozen trees (no compile, no init): its
    schedule bank and `_make_noisy_latents` need none."""
    config = JConfig(seed=seed, **cfg)
    unet, vae = JUNet(JUNetConfig.tiny(**UNET)), JVAE(JVAEConfig(**VAE))
    if geowizard:
        encoder = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(hidden_size=32, projection_dim=32))
        return JGeoTrainer(config, unet, vae, {}, encoder, {})
    return JTrainer(config, unet, vae, {}, np.zeros((1, 2, 32), np.float32))


def pyramid_draws_of(key, shape, sizes):
    """The JAX pyramid's draws from its noise key: the base, then one per octave."""
    b, _, _, c = shape
    keys = jax.random.split(key, len(sizes))
    return (jax.random.normal(key, shape, jnp.float32),
            [jax.random.normal(keys[i], (b, oh, ow, c), jnp.float32) for i, (oh, ow) in enumerate(sizes)])


@pytest.mark.parametrize("geowizard", [False, True], ids=["marigold-bank", "geowizard-bank"])
@pytest.mark.parametrize("seed", [0, 7])
def test_schedule_bank_and_octave_sizes_match(geowizard, seed):
    """The 16-row bank (r ~ U[2, 4] for the Marigold / SD trainer, U[1.5, 3]
    for GeoWizard's) and each row's octave sizes at the trainers' latent sizes."""
    want = jax_trainer(geowizard, seed)._pyramid_scale_bank
    base = (1.5, 1.5) if geowizard else (2.0, 2.0)
    got = pyramid_scale_bank(seed, *base)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, 10)
    for row in got:
        for h, w in LATENT_HW:
            assert tnoise._octave_sizes(h, w, row) == jnoise._octave_sizes(h, w, row)


def test_octave_sizes_break_at_one():
    sizes = tnoise._octave_sizes(64, 64, np.full(10, 2.0))
    assert sizes == jnoise._octave_sizes(64, 64, np.full(10, 2.0))
    assert sizes[0] == (64, 64) and 1 in sizes[-1] and len(sizes) == 7


@pytest.mark.parametrize("shape", [(2, 32, 40, 4), (1, 60, 80, 4), (3, 7, 5, 4)])
@pytest.mark.parametrize("variant", ["pyramid", "geowizard"])
def test_pyramid_compose_matches_jax(shape, variant):
    """The port's compose on the JAX draws against `pyramid` / `pyramid_geowizard`:
    the same octave sizes (the JAX key's host schedule), upsample, discount,
    per-sample t/1000 on the octaves and ddof=1 normalization."""
    key = jax.random.key(sum(shape))
    t = jnp.asarray([999, 250, 0][: shape[0]])
    if variant == "pyramid":
        want, base, spread, ts = jnoise.pyramid(key, shape), 2.0, 2.0, None
    else:
        want, base, spread = jnoise.pyramid_geowizard(key, shape, t), 1.5, 1.5
        ts = torch.from_numpy(np.array(t)) / 1000.0
    sched_key, noise_key = jax.random.split(key)
    sizes = jnoise._shape_schedule(sched_key, shape[1], shape[2], 10, base, spread)
    noise, octaves = pyramid_draws_of(noise_key, shape, sizes)
    got = tnoise.pyramid_compose(nchw(noise), [nchw(o) for o in octaves], 0.9, ts)
    assert got.shape == (shape[0], shape[3], shape[1], shape[2])
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("geowizard", [False, True], ids=["e2e", "geowizard"])
def test_trainer_pyramid_matches_jax(geowizard):
    """The trainers' pyramid latent: the bank row and draws the JAX trainer
    takes from its key, composed by the port, against the JAX trainer's
    `_make_noisy_latents` (GeoWizard's with t/1000 octave scaling)."""
    jt = jax_trainer(geowizard, seed=3, noise_type="pyramid")
    shape = (4, 6, 8, 4)
    t = jnp.asarray([999, 10, 999, 10]) if geowizard else None
    key = jax.random.key(11)
    want = jt._make_noisy_latents(key, shape, timesteps=t)
    idx_key, noise_key = jax.random.split(key)
    row = int(jax.random.randint(idx_key, (), 0, 16))
    sizes = tnoise._octave_sizes(6, 8, pyramid_scale_bank(3, *((1.5, 1.5) if geowizard else (2.0, 2.0)))[row])
    noise, octaves = pyramid_draws_of(noise_key, shape, sizes)
    ts = None if t is None else torch.from_numpy(np.array(t)).float() / 1000.0
    got = tnoise.pyramid_compose(nchw(noise), [nchw(o) for o in octaves], 0.9, ts)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def port_trainer(noise_type, seed=0):
    unet = UNet2DCondition(UNetConfig.tiny(**UNET))
    return E2ETrainer(TrainConfig(noise_type=noise_type, seed=seed, fused_vae_kernels=False), unet,
                      AutoencoderKL(VAEConfig(**VAE)), np.zeros((1, 2, 32), np.float32))


@pytest.mark.parametrize("noise_type", ["gaussian", "pyramid"])
def test_trainer_noise_deterministic_in_the_generator(noise_type):
    trainer = port_trainer(noise_type)
    shape = (2, 4, 12, 16)

    def draw(seed):
        return trainer._make_noisy_latents(shape, torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == shape and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_allclose(float(a.std()), 1.0, atol=0.1 if noise_type == "gaussian" else 1e-5)
    gen = torch.Generator().manual_seed(0)
    assert not torch.equal(trainer._make_noisy_latents(shape, gen), trainer._make_noisy_latents(shape, gen))
    with pytest.raises(ValueError, match="Generator"):
        trainer._make_noisy_latents(shape, None)


def test_trainer_zeros_noise_ignores_the_generator():
    trainer = port_trainer("zeros")
    assert not trainer._make_noisy_latents((1, 4, 6, 8), None).any()


@pytest.mark.parametrize("variant", ["pyramid", "geowizard"])
def test_pyramid_unit_std_and_determinism(variant):
    """ddof=1 unit std (torch's `.std()`, as the reference), the shape, and
    the same output for the same generator state."""
    shape = (2, 4, 32, 40)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        if variant == "pyramid":
            return tnoise.pyramid(gen, shape)
        return tnoise.pyramid_geowizard(gen, shape, torch.tensor([999, 500]))

    a = draw(0)
    assert a.shape == shape
    np.testing.assert_allclose(float(a.std(correction=1)), 1.0, rtol=1e-5)
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))


def test_geowizard_pyramid_at_t0_is_the_base():
    """At t = 0 every octave but the base is scaled away."""
    base = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(2))
    octaves = [torch.randn((1, 4, 8, 8)), torch.randn((1, 4, 4, 4))]
    got = tnoise.pyramid_compose(base, octaves, 0.9, torch.zeros(1))
    torch.testing.assert_close(got, base / base.std(), rtol=0, atol=0)


def test_make_noise():
    gen = torch.Generator().manual_seed(0)
    assert not tnoise.make_noise("zeros", (1, 4, 2, 2)).any() and not tnoise.make_noise(None, (1, 4, 2, 2)).any()
    g = tnoise.make_noise("gaussian", (2, 4, 8, 8), generator=gen)
    torch.testing.assert_close(g, torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(0)))
    p = tnoise.make_noise("pyramid", (2, 4, 8, 8), generator=gen)
    np.testing.assert_allclose(float(p.std()), 1.0, rtol=1e-5)
    for noise_type in ("gaussian", "pyramid"):  # as the JAX package raises without a key
        with pytest.raises(ValueError, match="Generator"):
            tnoise.make_noise(noise_type, (1, 4, 2, 2))
    with pytest.raises(ValueError, match="Unknown noise type"):
        tnoise.make_noise("uniform", (1, 4, 2, 2), generator=gen)


def test_member_draws_are_per_member():
    """An ensemble's draws, member by member as the JAX pipelines make them:
    cutting the ensemble into chunks leaves every member's initial latent and
    step noise as they were, each pyramid member is divided by its own std,
    and the draws are fp32 cast to the pipeline's dtype."""
    shape = (4, 12, 10)
    whole, steps = tnoise.member_draws("pyramid", torch.Generator().manual_seed(3), 5, shape, 2, torch.bfloat16)
    assert whole.shape == (5, *shape) and whole.dtype == torch.bfloat16 and len(steps) == 2
    gen = torch.Generator().manual_seed(3)
    parts = [tnoise.member_draws("pyramid", gen, n, shape, 2, torch.bfloat16) for n in (2, 3)]
    assert torch.equal(whole, torch.cat([p[0] for p in parts]))
    for i in range(2):
        assert steps[i].shape == whole.shape and torch.equal(steps[i], torch.cat([p[1][i] for p in parts]))
    fp32, _ = tnoise.member_draws("pyramid", torch.Generator().manual_seed(3), 5, shape, 2)
    assert torch.equal(fp32.to(torch.bfloat16), whole)
    np.testing.assert_allclose([float(m.std()) for m in fp32], 1.0, atol=1e-5)
    zeros, none = tnoise.member_draws("zeros", gen, 3, shape)
    assert not zeros.any() and none == []
