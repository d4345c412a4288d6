"""Slice B as a whole: GeoWizard joint depth + normals in the torch port against
the JAX package, fp32 on the CPU, with one seeded param set (UNet, VAE, CLIP
vision tower) written by the JAX package as an HF pipeline directory and
loaded by the port: the UNet with its class embedding and joint attention,
the switcher goldens, the device body (one step, and three DDIM steps from a
pyramid latent), `__call__` (one member, and a 3-member pyramid-noise
ensemble fed the JAX draws), loading in both directions, the options slice C
ported, the default device, and the kernel launches of the full-width
model's requests, traced on the meta device.

Tolerances: the UNet and the device bodies 1e-4 (fp32 summation order through
the towers); `__call__` 1e-3, since it min-max rescales the depth by its
small random-weight range, which amplifies those differences (an ensemble's
members too); an ensembled depth and its uncertainty within `ENSEMBLE_DRIFT`
(scipy's BFGS over a float32 objective; `_torch_port.py` says why)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ENSEMBLE_DRIFT, feed_draws, geowizard_flax_params, jax_member_latents, load_geowizard_into
from _torch_port import nchw, read_key_inventory, record
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.models import convert as jconvert
from diffusion_e2e_ft_tpu.ops import ensemble as jens
from diffusion_e2e_ft_tpu.ops import noise as jnoise
from diffusion_e2e_ft_tpu.ops import scheduler as jsched
from diffusion_e2e_ft_tpu.pipelines import GeoWizardPipeline as JGeoWizard
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu.pipelines.geowizard import GeoWizardOutput as JGeoWizardOutput
from diffusion_e2e_ft_tpu.pipelines.geowizard import domain_one_hot as j_one_hot
from diffusion_e2e_ft_tpu.pipelines.geowizard import switcher_embedding as j_switcher
from diffusion_e2e_ft_tpu_torch import kernels, parallel
from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as tfa
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as tclip
from diffusion_e2e_ft_tpu_torch.ops import ensemble as tens
from diffusion_e2e_ft_tpu_torch.models import convert as tconvert
from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, MarigoldPipeline, loading as tloading
from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import GeoWizardOutput, domain_one_hot, switcher_embedding

tattn = importlib.import_module("diffusion_e2e_ft_tpu_torch.kernels.attention")

# the UNet cut to two levels, the VAE and the vision tower at the JAX from_random's tiny widths
UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1, cross_attention_dim=32)
VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, image_size=224, patch_size=32,
              projection_dim=32)
H, W = 64, 48  # latent 8 x 6: H != W catches a transposed layout
LATENT = (1, H // 8, W // 8, 4)  # one member's JAX latent (NHWC)
SEED, STEPS = 7, 3


@pytest.fixture(scope="module")
def params():
    return geowizard_flax_params(JUNetConfig.geowizard(**UNET), JVAEConfig(**VAE), jclip.CLIPVisionConfig(**VISION),
                                 seed=10)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory, params):
    path = str(tmp_path_factory.mktemp("geowizard"))
    jloading.save_pipeline_dir(
        path, JUNetConfig.geowizard(**UNET), params["unet"], JVAEConfig(**VAE), params["vae"],
        jsched.SchedulerConfig(), pipeline_class="GeoWizardPipeline",
        image_encoder_config=jclip.CLIPVisionConfig(**VISION), image_encoder_params=params["image_encoder"],
    )
    return path


@pytest.fixture(scope="module")
def pipes(params, checkpoint):
    """(JAX pipeline from the random trees, the port's pipeline loaded from the JAX-written directory)."""
    jp = JGeoWizard(JUNet(JUNetConfig.geowizard(**UNET)), JVAE(JVAEConfig(**VAE)),
                    jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**VISION)),
                    params["unet"], params["vae"], params["image_encoder"], jsched.SchedulerConfig())
    return jp, tloading.load_geowizard_pipeline(checkpoint, device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def rgb():
    return np.random.default_rng(11).uniform(-1, 1, (1, H, W, 3)).astype(np.float32)


def test_unet_matches_jax(params):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, H // 8, W // 8, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 1, 32)).astype(np.float32)
    cls = np.array(j_switcher(j_one_hot("object"), batch=1))
    want = np.asarray(JUNet(JUNetConfig.geowizard(**UNET)).apply(
        {"params": params["unet"]}, jnp.asarray(x), jnp.asarray(999), jnp.asarray(ctx), jnp.asarray(cls)))
    unet, _, _ = load_geowizard_into(UNet2DCondition(UNetConfig.geowizard(**UNET)), AutoencoderKL(VAEConfig(**VAE)),
                                     tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig(**VISION)), params)
    with torch.no_grad():
        got = unet(torch.from_numpy(x).permute(0, 3, 1, 2), 999, torch.from_numpy(ctx), torch.from_numpy(cls))
        with pytest.raises(ValueError, match="class_labels"):
            unet(torch.from_numpy(x).permute(0, 3, 1, 2), 999, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-4, rtol=0)


def test_full_width_unet_keys_match_hf_inventory():
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.geowizard())
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == read_key_inventory("geowizard_unet")


@pytest.mark.parametrize("domain", ["indoor", "outdoor", "object"])
@pytest.mark.parametrize("batch", [1, 2])
def test_switcher_goldens(domain, batch):
    np.testing.assert_array_equal(domain_one_hot(domain), j_one_hot(domain))
    emb = switcher_embedding(domain_one_hot(domain), batch=batch)
    assert emb.shape == (2 * batch, 10) and emb.dtype == torch.float32
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_switcher(j_one_hot(domain), batch=batch)), atol=1e-7)
    # depth rows sin/cos([0, 1]), then normal rows sin/cos([1, 0])
    np.testing.assert_allclose(emb[0, :4].numpy(), [0, np.sin(1), 1, np.cos(1)], atol=1e-6)
    np.testing.assert_allclose(emb[batch, :4].numpy(), [np.sin(1), 0, np.cos(1), 1], atol=1e-6)
    with pytest.raises(ValueError):
        domain_one_hot("space")


def test_loaded_weights_match_in_both_packages(params, checkpoint, pipes):
    """The JAX-written directory loads in the port with the JAX trees' values,
    and the JAX loader reads the same values back."""
    _, tp = pipes
    jl = jloading.load_geowizard_pipeline(checkpoint)
    assert tp.unet.config.joint_attention and tp.unet.config.class_embed_proj_dim == 10
    assert tp.unet.config.use_linear_projection is False
    for got, sd in (
        (tp.unet, tconvert.flax_params_to_state_dict(params["unet"])),
        (tp.vae, tconvert.flax_params_to_state_dict(params["vae"])),
        (tp.image_encoder, tconvert.clip_vision_params_to_state_dict(params["image_encoder"])),
        (tp.image_encoder, tconvert.clip_vision_params_to_state_dict(jl.params["image_encoder"])),
        (tp.unet, tconvert.flax_params_to_state_dict(jl.params["unet"])),
    ):
        state = got.state_dict()
        assert sorted(state) == sorted(sd)
        for key, value in sd.items():
            np.testing.assert_array_equal(state[key].numpy(), np.asarray(value), err_msg=key)


def test_port_export_loads_in_jax(tmp_path, pipes):
    """The port's `save_pipeline_dir` with an image encoder: the JAX loader
    reads every tower back with the same values."""
    _, tp = pipes
    path = str(tmp_path / "export")
    tloading.save_pipeline_dir(path, tp.unet.config, tp.unet.state_dict(), tp.vae.config, tp.vae.state_dict(),
                               tp.scheduler_config, image_encoder_config=tp.image_encoder.config,
                               image_encoder_state=tp.image_encoder.state_dict())
    jl = jloading.load_geowizard_pipeline(path)
    assert jl.unet.config.joint_attention and jl.unet.config.class_embed_proj_dim == 10
    for module, tree, to_sd in ((tp.unet, jl.params["unet"], jconvert.params_to_state_dict),
                                (tp.image_encoder, jl.params["image_encoder"], tconvert.clip_vision_params_to_state_dict)):
        sd = to_sd(tree)
        for key, value in module.state_dict().items():
            np.testing.assert_array_equal(np.asarray(sd[key]), value.numpy(), err_msg=key)


def test_device_body_matches(pipes, rgb):
    jp, tp = pipes
    dom = jnp.asarray(j_one_hot("indoor"))
    want_d, want_n = (np.asarray(x) for x in jp._infer_jit(jp.params, jnp.asarray(rgb), 1,
                                                              jnp.zeros((1, H // 8, W // 8, 4)), dom))
    got_d, got_n = tp.infer(torch.from_numpy(rgb), "indoor")
    assert got_d.shape == (1, H, W) and got_n.shape == (1, H, W, 3)
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_n.numpy(), want_n, atol=1e-4, rtol=0)


def test_call_matches(pipes):
    jp, tp = pipes
    image = np.random.default_rng(13).integers(0, 256, (H // 2, W // 2, 3), dtype=np.uint8)
    kw = dict(processing_res=H, domain="outdoor", color_map=None)  # up to 64 x 48, back to 32 x 24
    want, got = jp(image, **kw), tp(image, **kw)
    assert got.depth_np.shape == want.depth_np.shape == (H // 2, W // 2)
    assert got.normal_np.shape == want.normal_np.shape == (H // 2, W // 2, 3)
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.normal_np, want.normal_np, atol=1e-3, rtol=0)
    assert got.normal_colored.dtype == np.uint8


def test_call_with_jax_keywords_matches(pipes):
    """The JAX keyword set runs in both packages with the same output: with one
    member and zeros noise, `seed`, `batch_size` and `ensemble_kwargs` change
    nothing, and `uncertainty` stays None."""
    jp, tp = pipes
    image = np.random.default_rng(14).integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = dict(processing_res=H, domain="indoor", color_map=None, seed=0, batch_size=1, ensemble_kwargs={})
    want, got = jp(image, **kw), tp(image, **kw)
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.normal_np, want.normal_np, atol=1e-3, rtol=0)
    assert got.uncertainty is None and want.uncertainty is None


def test_output_fields_match_jax():
    names = [f.name for f in dataclasses.fields(GeoWizardOutput)]
    assert names == [f.name for f in dataclasses.fields(JGeoWizardOutput)]
    assert names[-1] == "uncertainty"


def test_unported_options_raise(monkeypatch, pipes):
    """The options that raised before slice C now run and match the JAX
    package: an ensemble (of zeros-noise members, identical draws in both)
    with its uncertainty, and a gaussian-noise member (the JAX draw fed to
    the port). Since slice F the multi-device mesh runs too: the ensemble on
    [cpu, cpu] (one member on a replica of its own, as a second card holds)
    is the no-mesh one, bit for bit."""
    jp, tp = pipes
    image = np.random.default_rng(15).integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = dict(processing_res=0, domain="indoor", color_map=None, seed=0)
    want, got = jp(image, ensemble_size=2, **kw), tp(image, ensemble_size=2, **kw)
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=ENSEMBLE_DRIFT, rtol=0)
    np.testing.assert_allclose(got.normal_np, want.normal_np, atol=1e-3, rtol=0)
    assert got.uncertainty.shape == want.uncertainty.shape == (H, W)
    try:
        tp.with_mesh(parallel.make_mesh(devices=["cpu", "cpu"]))._replicas[1] = tp._replica_on(torch.device("cpu"))
        meshed = tp(image, ensemble_size=2, batch_size=2, **kw)
    finally:
        tp.with_mesh(None)
    for field in ("depth_np", "normal_np", "uncertainty"):
        np.testing.assert_array_equal(getattr(meshed, field), getattr(got, field), err_msg=field)
    want = jp(image, noise="gaussian", **kw)
    feed_draws(monkeypatch, jax_member_latents("gaussian", 0, 1, LATENT))
    got = tp(image, noise="gaussian", **kw)
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.normal_np, want.normal_np, atol=1e-3, rtol=0)


def test_multi_step_device_body_matches(pipes, rgb):
    """Three DDIM steps from one pyramid latent, shared by the task pair."""
    jp, tp = pipes
    latent0 = np.array(jnoise.make_noise("pyramid", jax.random.key(SEED), LATENT, jnp.float32))
    want_d, want_n = (np.asarray(x) for x in jp._infer_jit(jp.params, jnp.asarray(rgb), STEPS, jnp.asarray(latent0),
                                                              jnp.asarray(j_one_hot("object"))))
    got_d, got_n = tp.infer(torch.from_numpy(rgb), "object", STEPS, nchw(latent0))
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_n.numpy(), want_n, atol=1e-4, rtol=0)


def test_call_ensemble_matches(monkeypatch, pipes):
    """A 3-member pyramid-noise ensemble at three steps: JAX in batch-1
    chunks, the port in chunks of 2 and 1 (a 2N = 4 UNet batch with joint
    attention over each member's pair), fed the JAX members' latents."""
    jp, tp = pipes
    image = np.random.default_rng(16).integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = dict(processing_res=0, denoising_steps=STEPS, ensemble_size=3, noise="pyramid", seed=SEED,
              domain="outdoor", color_map=None)
    want_depths, want_normals = record(monkeypatch, jens, "ensemble_depths"), record(monkeypatch, jens,
                                                                                      "ensemble_normals")
    want = jp(image, batch_size=1, **kw)
    feed_draws(monkeypatch, jax_member_latents("pyramid", SEED, 3, LATENT))
    got_depths, got_normals = record(monkeypatch, tens, "ensemble_depths"), record(monkeypatch, tens,
                                                                                    "ensemble_normals")
    got = tp(image, batch_size=2, **kw)
    assert got_depths[0].shape == want_depths[0].shape == (3, H, W)
    np.testing.assert_allclose(got_depths[0], want_depths[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_normals[0], want_normals[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.normal_np, want.normal_np, atol=1e-3, rtol=0)  # the same member
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=ENSEMBLE_DRIFT, rtol=0)
    assert got.uncertainty.shape == want.uncertainty.shape == (H, W)
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, atol=ENSEMBLE_DRIFT, rtol=0)


def test_seed_gives_the_same_bits(pipes):
    _, tp = pipes
    image = np.random.default_rng(17).integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = dict(processing_res=0, denoising_steps=2, ensemble_size=2, noise="pyramid", batch_size=2, color_map=None)
    a, b, c = tp(image, seed=5, **kw), tp(image, seed=5, **kw), tp(image, seed=6, **kw)
    np.testing.assert_array_equal(a.depth_np, b.depth_np)
    np.testing.assert_array_equal(a.normal_np, b.normal_np)
    np.testing.assert_array_equal(a.uncertainty, b.uncertainty)
    assert not np.array_equal(a.depth_np, c.depth_np)


@pytest.mark.parametrize(
    "entry",
    ["GeoWizardPipeline.from_random", "GeoWizardPipeline.from_hf_dir", "load_geowizard_pipeline",
     "GeoWizardPipeline", "MarigoldPipeline.from_random"],
)
def test_entry_points_default_to_cuda(entry, checkpoint, pipes):
    """Without `device`, an entry point puts the models on the card: on this
    machine, which has none, it raises instead of running on the CPU."""
    _, tp = pipes
    calls = {
        "GeoWizardPipeline.from_random": lambda: GeoWizardPipeline.from_random(),
        "GeoWizardPipeline.from_hf_dir": lambda: GeoWizardPipeline.from_hf_dir(checkpoint),
        "load_geowizard_pipeline": lambda: tloading.load_geowizard_pipeline(checkpoint),
        "GeoWizardPipeline": lambda: GeoWizardPipeline(tp.unet, tp.vae, tp.image_encoder, tp.scheduler_config),
        "MarigoldPipeline.from_random": lambda: MarigoldPipeline.from_random(),
    }
    if torch.cuda.is_available():
        pytest.skip("with a card the default device is that card; this checks the refusal without one")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[entry]()
    assert tp.unet.conv_in.weight.device.type == "cpu"  # a refused move leaves the shared modules in place


def _request_sites(monkeypatch, height, width):
    """(B*N, Lq, Lk, d) of every attention call of one full-width GeoWizard
    request (VAE encode, the UNet on the task pair, the batch-2 decode),
    traced on the meta device (shapes only)."""
    sites = []

    def record(q, k, v, *, scale=None):
        sites.append((q.shape[0] * q.shape[2], q.shape[1], k.shape[1], q.shape[-1]))
        return tfa.flash_attention_reference(q, k, v, scale)

    monkeypatch.setattr(kernels, "attention", record)  # the layers' calls
    monkeypatch.setattr(tattn, "attention", record)  # joint_attention's call
    with torch.device("meta"), torch.inference_mode():
        unet, vae = UNet2DCondition(UNetConfig.geowizard()), AutoencoderKL(VAEConfig())
        z = vae.encode_mean(torch.empty(1, 3, height, width))
        unet(torch.empty(2, 8, *z.shape[2:]), 999, torch.empty(2, 1, 768), torch.empty(2, 10))
        vae.decode(torch.cat([z, z]))
    return sites


@pytest.mark.parametrize("hw,forward,mh", [((768, 768), 18, 5), ((576, 768), 17, 5)], ids=["768x768", "576x768"])
def test_launches_per_request(monkeypatch, hw, forward, mh):
    sites = _request_sites(monkeypatch, *hw)
    assert len(sites) == 2 * 16 + 2  # 16 transformer sites x (joint self + cross) + 2 VAE mid attentions
    inside = [s for s in sites if tattn.cuda_route(*s[1:], needs_grad=False) == "forward"]
    assert len(inside) == forward
    assert sorted({d for _, _, _, d in inside}) == [40, 80, 160, 512]
    assert all(lk > 1 for _, _, lk, _ in inside)  # never the one-token cross-attention
    monkeypatch.setenv("E2EFT_FA_HP", "2")
    packed = [s for s in inside if tfa.heads_per_cta(*s) == 2]
    assert len(packed) == mh and all(d == 40 and bn == 8 for bn, _, _, d in packed)
