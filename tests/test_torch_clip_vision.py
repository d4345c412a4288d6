"""The torch port's CLIP vision tower (GeoWizard's image encoder) and
`clip_preprocess` against the JAX package's `models/clip.py`, fp32 on the CPU,
with the same seeded weights carried across by the port's converter; and the
full-width ViT-L/14 tower's keys against the frozen HF inventory.

Tolerance 1e-5: fp32 on both sides, summation order only (a 2-layer tower;
the resize is the same antialiased Keys a = -0.5 cubic in both, 1e-5 in pixel
units before the CLIP normalization)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import random_flax_params, read_key_inventory
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu_torch.models import clip as tclip
from diffusion_e2e_ft_tpu_torch.models import convert as tconvert

TINY = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, image_size=224, patch_size=32,
            projection_dim=24)


@pytest.fixture(scope="module")
def params():
    return random_flax_params(jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**TINY)), 3,
                              jnp.ones((1, 224, 224, 3)))


def _port_tower(params):
    tower = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig(**TINY))
    sd = tconvert.clip_vision_params_to_state_dict(params)
    tower.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return tower.eval()


def test_converter_matches_jax_export(params):
    """The port's vision converter gives the JAX package's export keys and
    values, and inverts exactly."""
    got = tconvert.clip_vision_params_to_state_dict(params)
    want = jloading._clip_params_to_state_dict(params, "vision")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
    back = tconvert.clip_vision_params_to_state_dict(tconvert.clip_vision_state_dict_to_flax_params(got))
    assert all(np.array_equal(back[k], got[k]) for k in got)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_tower_matches_jax(params, act):
    cfg = dict(TINY, hidden_act=act)
    pix = np.random.default_rng(4).standard_normal((2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**cfg)).apply(
        {"params": params}, jnp.asarray(pix)))
    tower = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig(**cfg))
    tower.load_state_dict(_port_tower(params).state_dict(), strict=True)
    with torch.no_grad():
        got = tower.eval()(torch.from_numpy(pix).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, TINY["projection_dim"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(48, 64), (480, 640)], ids=["upscale", "downscale"])
def test_clip_preprocess_matches_jax(hw):
    img = np.random.default_rng(5).random((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jclip.clip_preprocess(jnp.asarray(img)))  # [B, 224, 224, 3]
    got = tclip.clip_preprocess(torch.from_numpy(img))  # [B, 3, 224, 224]
    assert got.shape == (2, 3, 224, 224)
    # 1e-5 in pixel units (the two resizes' fp32 summation orders), through the
    # normalization's division by the CLIP std
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5 / min(tclip.CLIP_IMAGE_STD), rtol=0)


def test_full_width_tower_keys_match_hf_inventory():
    """ViT-L/14 (the default config): every HF key and shape, none extra; the
    `position_ids` buffer is the one key the loader drops."""
    with torch.device("meta"):
        tower = tclip.CLIPVisionModelWithProjection()
    got = {k: tuple(v.shape) for k, v in tower.state_dict().items()}
    want = {k: s for k, s in read_key_inventory("clip_vision_vitl").items() if "position_ids" not in k}
    assert got == want
