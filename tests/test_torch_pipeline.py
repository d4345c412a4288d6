"""The slice as a whole: one HF-layout checkpoint, written by the JAX package,
loaded by both packages and run on the same image, fp32 on the CPU; and the
port's HTTP server answering on localhost.

Tolerances: the device bodies (VAE encode -> UNet -> DDIM x0 -> VAE decode ->
postprocess) agree to 1e-4, the towers' fp32 summation-order bound. `__call__`
then min-max rescales the depth, which divides by its (small, random-weight)
range and so amplifies those differences: 1e-3 there."""

import dataclasses
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import random_flax_params
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.ops import image as jim
from diffusion_e2e_ft_tpu.ops import scheduler as jsched
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu.pipelines.marigold import MarigoldOutput as JMarigoldOutput
from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService, serve
from diffusion_e2e_ft_tpu_torch.pipelines import loading as tloading
from diffusion_e2e_ft_tpu_torch.pipelines.marigold import MarigoldOutput

TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
TINY_TEXT = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    ucfg, vcfg = JUNetConfig.tiny(), JVAEConfig(**TINY_VAE)
    up = random_flax_params(JUNet(ucfg), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999), jnp.ones((1, 2, 32)))
    vp = random_flax_params(JVAE(vcfg), 1, jnp.ones((1, 64, 64, 3)))
    jloading.save_pipeline_dir(str(path), ucfg, up, vcfg, vp, jsched.SchedulerConfig())
    tcfg = jclip.CLIPTextConfig(**TINY_TEXT)
    tp = random_flax_params(jclip.CLIPTextModel(tcfg), 2, jnp.ones((1, 2), jnp.int32))
    jloading.save_text_encoder(str(path / "text_encoder"), tcfg, tp)
    return str(path)


@pytest.fixture(scope="module")
def pipes(checkpoint):
    return (
        jloading.load_marigold_pipeline(checkpoint),
        tloading.load_marigold_pipeline(checkpoint, device="cpu", dtype=torch.float32),
    )


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(3).integers(0, 256, (64, 48, 3), dtype=np.uint8)


def test_empty_text_embed_matches(pipes):
    jp, tp = pipes
    want = np.asarray(jp.params["empty_text_embed"])
    assert want.shape == (1, 2, 32)
    np.testing.assert_allclose(tp.empty_text_embed.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("normals", [False, True], ids=["depth", "normals"])
def test_device_body_matches(pipes, image, normals):
    jp, tp = pipes
    rgb = np.asarray(jim.normalize_rgb(jnp.asarray(image, jnp.float32)))[None]
    want = np.asarray(
        jp._infer_jit(jp.params, jnp.asarray(rgb), 1, normals, jnp.zeros((1, 8, 6, 4)), jax.random.key(0))
    )
    got = tp.infer(torch.from_numpy(rgb), 1, normals).numpy()
    assert got.shape == ((1, 64, 48, 3) if normals else (1, 64, 48))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("normals", [False, True], ids=["depth", "normals"])
def test_call_matches(pipes, image, normals):
    jp, tp = pipes
    kw = dict(processing_res=64, normals=normals, color_map=None)
    want, got = jp(image, **kw), tp(image, **kw)
    field = "normal_np" if normals else "depth_np"
    a, b = getattr(got, field), getattr(want, field)
    assert a.shape == b.shape == ((64, 48, 3) if normals else (64, 48))
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


@pytest.mark.parametrize("normals,batch_size", [(False, 2), (True, 1)], ids=["depth", "normals"])
def test_call_with_jax_keywords_matches(pipes, image, normals, batch_size):
    """The JAX keyword set runs in both packages with the same output: with one
    member and zeros noise, `seed`, `batch_size` (JAX runs the batch and keeps
    the first member) and `ensemble_kwargs` change nothing, and `uncertainty`
    stays None."""
    jp, tp = pipes
    kw = dict(processing_res=64, normals=normals, color_map=None, seed=0, batch_size=batch_size,
              ensemble_kwargs={})
    want, got = jp(image, **kw), tp(image, **kw)
    field = "normal_np" if normals else "depth_np"
    np.testing.assert_allclose(getattr(got, field), getattr(want, field), atol=1e-3, rtol=0)
    assert got.uncertainty is None and want.uncertainty is None


def test_output_fields_match_jax():
    names = [f.name for f in dataclasses.fields(MarigoldOutput)]
    assert names == [f.name for f in dataclasses.fields(JMarigoldOutput)]
    assert names == ["depth_np", "depth_colored", "uncertainty", "normal_np", "normal_colored"]


def test_with_mesh_raises_naming_slice_f(pipes):
    _, tp = pipes
    with pytest.raises(NotImplementedError, match="slice F"):
        tp.with_mesh(None)


def test_unported_options_raise(pipes, image):
    _, tp = pipes
    with pytest.raises(NotImplementedError, match="slice C"):
        tp(image, ensemble_size=2, processing_res=64)
    with pytest.raises(NotImplementedError, match="slice C"):
        tp(image, noise="gaussian", processing_res=64)


@pytest.mark.parametrize("entry", ["load_marigold_pipeline", "MarigoldPipeline.from_hf_dir", "compute_empty_text_embed"])
def test_entry_points_default_to_cuda(checkpoint, entry):
    """Without `device`, the loaders put the models on the card: on this
    machine, which has none, they raise instead of running on the CPU."""
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    calls = {
        "load_marigold_pipeline": lambda: tloading.load_marigold_pipeline(checkpoint),
        "MarigoldPipeline.from_hf_dir": lambda: MarigoldPipeline.from_hf_dir(checkpoint),
        "compute_empty_text_embed": lambda: tloading.compute_empty_text_embed(f"{checkpoint}/text_encoder"),
    }
    if torch.cuda.is_available():
        pytest.skip("with a card the default device is that card; this checks the refusal without one")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        calls[entry]()


def test_http_server_answers(pipes):
    from PIL import Image

    _, tp = pipes
    service = PipelineService(tp, processing_res=64, denoise_steps=1)
    server = serve(service, "127.0.0.1", 0)
    try:
        service.warmup()
        host, port = server.server_address
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
            assert r.status == 200 and json.loads(r.read())["ready"] is True
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(4).integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(buf, "PNG")
        req = urllib.request.Request(f"http://{host}:{port}/v1/depth", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "application/x-npy"
            pred = np.load(io.BytesIO(r.read()))
    finally:
        server.shutdown()
        server.server_close()
    assert pred.shape == (48, 64)
    assert np.isfinite(pred).all() and pred.min() >= 0 and pred.max() <= 1
