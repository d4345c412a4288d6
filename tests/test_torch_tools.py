"""Slice G on the CPU: the port's parity tools (`diffusion_e2e_ft_tpu_torch/
tools/{activation_diff,export_roundtrip,hf_key_inventory}.py`) against the
JAX package's.

- `capture_intermediates` by forward hooks on a tiny two-level UNet against
  the JAX `capture_intermediates` (flax) on the same weights and inputs:
  every layer both packages have (the resnets, the attentions and their
  transformer blocks, the down / up blocks' outputs, tuple elements
  included, and the layer norms and projections the port runs as modules
  of their own) within 1e-4, under one key each, NCHW against NHWC.
- The diff reconciles layouts both ways, canonicalizes both dialects, reads
  reference directories, and finds the first divergence.
- The export round trip on a tiny pipeline, fp32 and bf16: zero difference.
- The inventory builders, writer and parser equal the JAX module's on every
  frozen fixture.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, nchw, random_flax_params, read_key_inventory
from diffusion_e2e_ft_tpu.models import UNet2DCondition as JUNet, UNetConfig as JUNetConfig
from diffusion_e2e_ft_tpu.tools import activation_diff as JAD
from diffusion_e2e_ft_tpu.tools import hf_key_inventory as JINV
from diffusion_e2e_ft_tpu_torch.models import UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as tclip
from diffusion_e2e_ft_tpu_torch.tools import activation_diff as AD
from diffusion_e2e_ft_tpu_torch.tools import export_roundtrip as ER
from diffusion_e2e_ft_tpu_torch.tools import hf_key_inventory as INV

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "hf_keys")
UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1)


@pytest.fixture(scope="module")
def captures():
    """(the port's captures, the JAX package's) of one tiny UNet forward."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    ctx = rng.normal(size=(1, 2, 32)).astype(np.float32)
    junet = JUNet(JUNetConfig.tiny(**UNET))
    params = random_flax_params(junet, 0, jnp.asarray(x), jnp.asarray(999), jnp.asarray(ctx))
    _, jacts = JAD.capture_intermediates(junet, {"params": params}, jnp.asarray(x), jnp.asarray([999]),
                                         jnp.asarray(ctx))
    unet = load_into(UNet2DCondition(UNetConfig.tiny(**UNET)), jax.tree.map(np.asarray, params))
    with torch.no_grad():
        _, acts = AD.capture_intermediates(unet, nchw(x), torch.tensor([999]), torch.from_numpy(ctx))
    return acts, jacts


def test_capture_matches_jax(captures):
    acts, jacts = captures
    rows = AD.diff(acts, jacts, rtol=1e-4, atol=1e-4)
    only = {r["layer"]: r["only_in"] for r in rows if "only_in" in r}
    assert not only, only
    compared = [r for r in rows if "only_in" not in r]
    assert all("max_abs_err" in r for r in compared), [r for r in compared if "max_abs_err" not in r][:3]
    bad = [r for r in compared if not r["within_tol"]]
    assert not bad, bad[:3]
    layers = {r["layer"] for r in compared}
    assert len(compared) == len(jacts)  # every flax capture has its port counterpart
    for key in ("", "conv_in", "time_embedding", "down_blocks_0/0", "down_blocks_0/1/0", "down_blocks_0/1/1",
                "down_blocks_1/1", "down_blocks_0/resnets_0", "down_blocks_0/attentions_0",
                "down_blocks_0/attentions_0/transformer_blocks_0/attn2/to_k", "mid_block", "mid_block/attentions_0",
                "up_blocks_0", "up_blocks_1/resnets_1", "up_blocks_1/attentions_1", "up_blocks_0/upsamplers_0"):
        assert key in layers, key
    assert AD.first_divergence(rows, 1e-4) is None
    # the JAX diff (which turns the reference's NCHW into NHWC) reads the same pairs with the port's as the
    # reference: every module path without a tuple index meets its flax row
    jrows = {r["layer"]: r for r in JAD.diff(jacts, acts, rtol=1e-4, atol=1e-4)}
    assert jrows["down_blocks_0/resnets_0"]["within_tol"] and jrows["mid_block/attentions_0"]["within_tol"]


def test_diff_reconciles_layouts_and_dialects(tmp_path):
    rng = np.random.default_rng(1)
    nhwc = rng.normal(size=(1, 8, 6, 3)).astype(np.float32)
    hwc = nhwc[0]
    for ours, ref in ((nhwc, nhwc.transpose(0, 3, 1, 2)), (nhwc.transpose(0, 3, 1, 2), nhwc),
                      (hwc, hwc.transpose(2, 0, 1)), (hwc.transpose(2, 0, 1), hwc)):
        assert AD.diff({"x": ours}, {"x": ref})[0]["max_abs_err"] == 0.0
    assert AD.canonicalize_path("down_blocks.0.resnets.1") == "down_blocks_0/resnets_1" == \
        AD.canonicalize_path("down_blocks_0/resnets_1")
    assert AD.canonicalize_path("down_blocks.0/1/0") == "down_blocks_0/1/0"
    assert AD.canonicalize_path("attn1.to_out.0") == "attn1/to_out_0" == JAD.canonicalize_path("attn1.to_out.0")
    rows = AD.diff({"block_0/conv": np.ones((2, 4, 4, 3), np.float32)},
                   {"block.0.conv": np.full((2, 4, 4, 3), 2.0, np.float32), "extra": np.ones(2)})
    by_layer = {r["layer"]: r for r in rows}
    assert by_layer["block_0/conv"]["max_abs_err"] == 1.0 and not by_layer["block_0/conv"]["within_tol"]
    assert rows[0] == {"layer": "extra", "only_in": "reference"}  # a one-sided layer sorts first
    assert AD.first_divergence(rows) == "block_0/conv"
    assert AD.summarize({"x": np.full((2, 2), 3.0, np.float32)})["x"] == {"shape": [2, 2], "mean": 3.0, "std": 0.0,
                                                                          "absmax": 3.0}
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.save(ref_dir / "down_blocks.0.resnets.1.npy", a)
    AD.save_dump(str(ref_dir / "extra.npz"), {"mid_block.attentions.0": a + 1.0})
    ours = str(tmp_path / "ours.npz")
    AD.save_dump(ours, {"down_blocks_0/resnets_1": a, "mid_block/attentions_0": a + 1.0})
    assert all(r.get("max_abs_err") == 0.0 for r in AD.diff(AD.load_dump(ours), AD.load_reference(str(ref_dir))))
    assert AD.main(["--ours", ours, "--reference", str(ref_dir)]) == 0


def test_tiny_export_roundtrip_is_zero_diff(tmp_path):
    unet = UNetConfig.tiny(**UNET)
    vae = VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
    text = tclip.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
    out = tmp_path / "report.md"
    ok, results, report = ER.run(str(out), device="cpu", dtypes=("float32", "bfloat16"), image_hw=(32, 48),
                                 unet_config=unet, vae_config=vae, text_config=text, workdir=str(tmp_path))
    assert ok and "ZERO-DIFF" in out.read_text() == report
    for r in results.values():
        assert [name for name, _ in r["rows"]][0].startswith("empty-prompt") and len(r["rows"]) == 4
        assert all(d == 0.0 for _, d in r["rows"] + r["self"]) and r["unet_tensors"] > 100


@pytest.mark.parametrize("name", list(JINV.INVENTORIES))
def test_inventory_matches_jax(name):
    port = INV.load_fixture(FIXTURES, name)
    assert port == JINV.load_fixture(FIXTURES, name) == read_key_inventory(name)
    assert INV.format_inventory(port) == JINV.format_inventory(port)
    assert INV.parse_inventory(INV.format_inventory(port)) == port
    if not name.startswith("clip"):  # the CLIP builders need transformers, which the port does not
        assert INV.INVENTORIES[name]() == JINV.INVENTORIES[name]() == port
