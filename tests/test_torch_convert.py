"""Weight conversion and file reading in the torch port, against the JAX package.

The port's converter must give the JAX package's HF state dict key for key and
value for value (UNet, VAE, CLIP text tower), load into the port's modules
with `strict=True`, and invert. The port's own safetensors reader (the H100
host has no `safetensors` package) must read what `safetensors` writes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import random_flax_params
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.models import convert as jconvert
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as tclip
from diffusion_e2e_ft_tpu_torch.models import convert as tconvert

TINY_TEXT = dict(vocab_size=49408, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                 max_position_embeddings=8)


def _unet():
    p = random_flax_params(JUNet(JUNetConfig.tiny()), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999),
                           jnp.ones((1, 2, 32)))
    return p, UNet2DCondition(UNetConfig.tiny())


def _vae():
    cfg = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
    p = random_flax_params(JVAE(JVAEConfig(**cfg)), 1, jnp.ones((1, 64, 64, 3)))
    return p, AutoencoderKL(VAEConfig(**cfg))


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("make", [_unet, _vae], ids=["unet", "vae"])
def test_converter_matches_jax_and_loads_strict(make):
    params, module = make()
    got = tconvert.flax_params_to_state_dict(params)
    _assert_same_dict(got, jconvert.params_to_state_dict(params))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    # and back: the inverse reproduces the tree leaf for leaf
    back = tconvert.flax_params_to_state_dict(tconvert.state_dict_to_flax_params(got))
    _assert_same_dict(back, got)


def test_clip_text_converter_matches_jax_and_loads_strict():
    cfg = jclip.CLIPTextConfig(**TINY_TEXT)
    params = random_flax_params(jclip.CLIPTextModel(cfg), 2, jnp.ones((1, 2), jnp.int32))
    got = tconvert.clip_text_params_to_state_dict(params)
    _assert_same_dict(got, jloading._clip_params_to_state_dict(params, "text"))
    model = tclip.CLIPTextModel(tclip.CLIPTextConfig(**TINY_TEXT))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()}, strict=True)
    back = tconvert.clip_text_params_to_state_dict(tconvert.clip_text_state_dict_to_flax_params(got))
    _assert_same_dict(back, got)


def test_clip_text_model_matches_jax():
    """The empty prompt through both text towers (fp32; 1e-5 for summation order)."""
    cfg = jclip.CLIPTextConfig(**TINY_TEXT)
    jm = jclip.CLIPTextModel(cfg)
    params = random_flax_params(jm, 3, jnp.ones((1, 2), jnp.int32))
    ids = jclip.empty_prompt_ids(pad_to=4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    model = tclip.CLIPTextModel(tclip.CLIPTextConfig(**TINY_TEXT))
    sd = tconvert.clip_text_params_to_state_dict(params)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(tclip.empty_prompt_ids(pad_to=4))).numpy()
    np.testing.assert_array_equal(tclip.empty_prompt_ids(pad_to=4), ids)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_safetensors_reader_matches_numpy_loader(tmp_path):
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(4)
    tensors = {
        "a.weight": rng.standard_normal((3, 4, 2, 2)).astype(np.float32),
        "b.bias": rng.standard_normal((5,)).astype(np.float16),
        "c.ids": np.arange(6, dtype=np.int64).reshape(2, 3),
        "d.empty": np.zeros((0, 3), np.float32),
    }
    path = str(tmp_path / "w.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tconvert.load_weights(path)
    want = load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert got[k].numpy().dtype == want[k].dtype


def test_safetensors_reader_bf16(tmp_path):
    from safetensors.torch import load_file, save_file

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 7)).astype(np.float32))
    path = str(tmp_path / "bf16.safetensors")
    save_file({"w": x.to(torch.bfloat16), "s": x[0]}, path)
    got, want = tconvert.load_weights(path), load_file(path)
    assert got["w"].dtype == torch.bfloat16
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bin_weights(tmp_path):
    sd = {"x.weight": torch.arange(6.0).reshape(2, 3)}
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(sd, path)
    assert torch.equal(tconvert.load_weights(path)["x.weight"], sd["x.weight"])


def test_old_vae_attention_names_canonicalize():
    sd = {"decoder.mid_block.attentions.0.query.weight": 1, "decoder.mid_block.attentions.0.proj_attn.bias": 2}
    assert tconvert.canonicalize_keys(sd) == {
        "decoder.mid_block.attentions.0.to_q.weight": 1,
        "decoder.mid_block.attentions.0.to_out.0.bias": 2,
    }
