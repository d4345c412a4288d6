"""Shared helpers of the torch-port parity tests (tests/test_torch_*.py).

JAX param trees come from the JAX module's own `init` signature
(`jax.eval_shape`, no compute) and are filled from `np.random.default_rng`:
kernels lecun-scaled, biases and norm scales perturbed away from 0 / 1 so a
mis-mapped bias or scale shows up. The port receives the same numbers through
its own converter.
"""

from __future__ import annotations

import os
from typing import Optional

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


def read_key_inventory(name: str) -> dict:
    """{HF key: shape} of a frozen inventory under tests/fixtures/hf_keys/,
    read by the port's own `tools/hf_key_inventory.py`."""
    from diffusion_e2e_ft_tpu_torch.tools.hf_key_inventory import load_fixture

    return load_fixture(os.path.join(os.path.dirname(__file__), "fixtures", "hf_keys"), name)


TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
TINY_TEXT = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)


def write_tiny_checkpoint(path, **unet) -> str:
    """A tiny Marigold HF pipeline directory written by the JAX package: the
    tiny UNet (`unet` overriding its fields), a 4-level VAE and a 2-layer text
    encoder, seeded numpy weights."""
    import jax.numpy as jnp

    from diffusion_e2e_ft_tpu.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu.models import clip
    from diffusion_e2e_ft_tpu.ops import scheduler as jsched
    from diffusion_e2e_ft_tpu.pipelines import loading

    ucfg, vcfg = UNetConfig.tiny(**unet), VAEConfig(**TINY_VAE)
    up = random_flax_params(UNet2DCondition(ucfg), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999), jnp.ones((1, 2, 32)))
    vp = random_flax_params(AutoencoderKL(vcfg), 1, jnp.ones((1, 64, 64, 3)))
    loading.save_pipeline_dir(str(path), ucfg, up, vcfg, vp, jsched.SchedulerConfig())
    tcfg = clip.CLIPTextConfig(**TINY_TEXT)
    tp = random_flax_params(clip.CLIPTextModel(tcfg), 2, jnp.ones((1, 2), jnp.int32))
    loading.save_text_encoder(os.path.join(str(path), "text_encoder"), tcfg, tp)
    return str(path)


def geowizard_flax_params(unet_config, vae_config, vision_config, seed: int) -> dict:
    """JAX GeoWizard param trees (UNet, VAE, CLIP vision tower) from one seed."""
    import jax.numpy as jnp

    from diffusion_e2e_ft_tpu.models import AutoencoderKL, UNet2DCondition
    from diffusion_e2e_ft_tpu.models import clip

    u, s = unet_config, vision_config.image_size
    return {
        "unet": random_flax_params(
            UNet2DCondition(u), seed, jnp.ones((2, 8, 8, u.in_channels)), jnp.asarray(999),
            jnp.ones((2, 1, u.cross_attention_dim)), jnp.ones((2, u.class_embed_proj_dim)),
        ),
        "vae": random_flax_params(AutoencoderKL(vae_config), seed + 1, jnp.ones((1, 32, 32, 3))),
        "image_encoder": random_flax_params(
            clip.CLIPVisionModelWithProjection(vision_config), seed + 2, jnp.ones((1, s, s, 3))
        ),
    }


def load_geowizard_into(unet, vae, image_encoder, params: dict):
    """Load `geowizard_flax_params` into port modules through the port's converters."""
    load_into(unet, params["unet"])
    load_into(vae, params["vae"])
    sd = tconvert.clip_vision_params_to_state_dict(params["image_encoder"])
    image_encoder.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return unet, vae, image_encoder.eval()


# ensemble_depths, two float32 objectives (the JAX package's and the port's, or the port's on two devices):
# scipy's BFGS walks them to other (s, t), so the ensembled depth and uncertainty ([0, 1] units) agree only
# within this drift. Over 64 ensembles of 3-10 noisy affine copies (32x32 to 96x128, both reductions, with
# and without max_res) the port and the JAX package differed by 4.6e-2 at most; the bound is about twice
# that. tests/test_torch_ensemble.py holds the objective and the combine step tightly.
ENSEMBLE_DRIFT = 0.1


def jax_member_latents(noise: str, seed: int, members: int, shape) -> list:
    """A JAX pipeline `__call__`'s initial latents, NCHW: member m draws
    `make_noise(noise, split(key(seed), E + 1)[1 + m], shape)` (shape NHWC, batch 1)."""
    from diffusion_e2e_ft_tpu.ops import noise as jnoise

    keys = jax.random.split(jax.random.key(seed), members + 1)[1:]
    return [nchw(np.array(jnoise.make_noise(noise, k, shape, np.float32))) for k in keys]


def feed_draws(monkeypatch, latents: list) -> None:
    """The port's `noise.member_draws` hands out `latents` member by member
    (and no step noise: DDIM)."""
    from diffusion_e2e_ft_tpu_torch.ops import noise as tnoise

    members = iter(latents)

    def draws(noise_type, generator, n, shape, num_step_noises=0, dtype=torch.float32):
        assert num_step_noises == 0 and tuple(shape) == tuple(latents[0].shape[1:])
        return torch.cat([next(members) for _ in range(n)]).to(dtype), []

    monkeypatch.setattr(tnoise, "member_draws", draws)


def record(monkeypatch, module, name: str) -> list:
    """Wrap `module.name` so that the first argument of each call (an
    ensemble's members) is kept, as numpy."""
    seen, fn = [], getattr(module, name)

    def wrapper(members, *args, **kw):
        seen.append(np.asarray(members))
        return fn(members, *args, **kw)

    monkeypatch.setattr(module, name, wrapper)
    return seen


def dp_scenario_flax_weights() -> tuple:
    """Seeded weights of `tests/_torch_dp_worker.py`'s models as the JAX
    package's trees: (SD2 UNet, SD2 VAE, GeoWizard {unet, vae,
    image_encoder}, the empty-text context)."""
    import jax.numpy as jnp

    import _torch_dp_worker as W
    from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
    from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
    from diffusion_e2e_ft_tpu.models import clip as jclip

    up = random_flax_params(JUNet(JUNetConfig.tiny(**W.UNET)), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999),
                            jnp.ones((1, 2, 32)))
    vp = random_flax_params(JVAE(JVAEConfig(**W.VAE)), 1, jnp.ones((1, 32, 32, 3)))
    geo = geowizard_flax_params(JUNetConfig.geowizard(**W.GEO_UNET), JVAEConfig(**W.GEO_VAE),
                                jclip.CLIPVisionConfig(**W.VISION), seed=20)
    return up, vp, geo, np.random.default_rng(2).normal(size=(1, 2, 32)).astype(np.float32)


def dp_scenario_weights(flax_weights: Optional[tuple] = None) -> dict:
    """`dp_scenario_flax_weights` (or the given trees) as the port's state
    dicts: the tiny SD2 UNet and VAE, the empty-text context, and
    GeoWizard's UNet, VAE and image tower."""
    up, vp, geo, empty = flax_weights or dp_scenario_flax_weights()

    def state_dict(tree):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in tconvert.flax_params_to_state_dict(jax.tree.map(np.array, tree)).items()}

    enc = tconvert.clip_vision_params_to_state_dict(geo["image_encoder"])
    return {"unet": state_dict(up), "vae": state_dict(vp), "geo_unet": state_dict(geo["unet"]),
            "geo_vae": state_dict(geo["vae"]), "empty": empty,
            "geo_encoder": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in enc.items()}}
