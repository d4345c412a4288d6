"""The slice as a whole: one HF-layout checkpoint, written by the JAX package,
loaded by both packages and run on the same image, fp32 on the CPU; and the
port's HTTP server answering on localhost.

Tolerances: the device bodies (VAE encode -> UNet -> DDIM x0 -> VAE decode ->
postprocess) agree to 1e-4, the towers' fp32 summation-order bound, also at
three DDIM, ancestral-DDPM and latent-consistency steps given the JAX draws
(the initial latent and the step noise the JAX body draws from its key).
`__call__` then min-max rescales the depth, which divides by its (small,
random-weight) range and so amplifies those differences: 1e-3 there, and for
an ensemble's members. An ensembled depth and its uncertainty go through
scipy's BFGS, which two float32 objectives walk to other (s, t): they agree
within `ENSEMBLE_DRIFT` (tests/test_torch_ensemble.py says why).

Random draws: the two packages' generators differ, so the `__call__` tests
hand the port the JAX package's per-member draws (`member_draws` patched);
a batch-1 JAX chunk starting at member `start` keys its steps with
`split(fold_in(key(seed), start), K)`."""

import dataclasses
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port
from _torch_port import ENSEMBLE_DRIFT, feed_draws, nchw, record
from diffusion_e2e_ft_tpu.ops import ensemble as jens
from diffusion_e2e_ft_tpu.ops import image as jim
from diffusion_e2e_ft_tpu.ops import noise as jnoise
from diffusion_e2e_ft_tpu.ops import scheduler as jsched
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu.pipelines.marigold import MarigoldOutput as JMarigoldOutput
from diffusion_e2e_ft_tpu.pipelines.marigold import MarigoldPipeline as JMarigoldPipeline
from diffusion_e2e_ft_tpu_torch import parallel
from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService, serve
from diffusion_e2e_ft_tpu_torch.pipelines import loading as tloading
from diffusion_e2e_ft_tpu_torch.ops import ensemble as tens
from diffusion_e2e_ft_tpu_torch.pipelines.marigold import MarigoldOutput, MarigoldPipeline

SEED, STEPS = 7, 3
LATENT = (1, 8, 6, 4)  # one member's JAX latent (NHWC) for the 64 x 48 image
# An ensemble's members through `__call__`, by task: depth 1e-3 (the min-max amplification above); normals
# 5e-3, since unit-normalising amplifies the towers' differences where |decoded| is small (read 2.2e-3 at
# 18 of 27648 values after three steps, 1e-5 or less elsewhere)
MEMBER_BOUND = {False: 1e-3, True: 5e-3}


def jax_member_latents(noise: str, seed: int, members: int) -> list:
    return _torch_port.jax_member_latents(noise, seed, members, LATENT)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return _torch_port.write_tiny_checkpoint(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def pipes(checkpoint):
    return (
        jloading.load_marigold_pipeline(checkpoint),
        tloading.load_marigold_pipeline(checkpoint, device="cpu", dtype=torch.float32),
    )


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(3).integers(0, 256, (64, 48, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def rgb(image):
    return np.array(jim.normalize_rgb(jnp.asarray(image, jnp.float32)))[None]


@pytest.fixture(scope="module")
def scheduler_pipes(pipes):
    """{scheduler type: (JAX pipeline, port pipeline)} over the checkpoint's weights."""
    jp, tp = pipes
    out = {"ddim": pipes}
    for kind in ("ddpm", "lcm"):
        out[kind] = (
            JMarigoldPipeline(jp.unet, jp.vae, jp.params["unet"], jp.params["vae"], jp.scheduler_config,
                              np.asarray(jp.params["empty_text_embed"]), scheduler_type=kind),
            MarigoldPipeline(tp.unet, tp.vae, tp.scheduler_config, tp.empty_text_embed, device="cpu",
                             scheduler_type=kind),
        )
    return out


def test_empty_text_embed_matches(pipes):
    jp, tp = pipes
    want = np.asarray(jp.params["empty_text_embed"])
    assert want.shape == (1, 2, 32)
    np.testing.assert_allclose(tp.empty_text_embed.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("normals", [False, True], ids=["depth", "normals"])
def test_device_body_matches(pipes, rgb, normals):
    jp, tp = pipes
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


def test_with_mesh_raises_naming_slice_f(pipes, image, monkeypatch):
    """`with_mesh` runs since slice F: on [cpu, cpu] (one member on a replica
    of its own, as a second card holds) a
    seeded two-member ensemble's members are the no-mesh ones, bit for bit
    (their BFGS alignment, the same function of the same members, is held in
    `test_call_ensemble_matches`; a mean stands in for it here). What still
    raised is the FSDP axis, which now lays its devices out as the JAX mesh
does and refuses a device count it does not divide."""
    _, tp = pipes
    members = []
    monkeypatch.setattr(tens, "ensemble_depths", lambda preds, **kw: (members.append(preds) or preds.mean(0),
                                                                       preds.std(0)))
    kw = dict(ensemble_size=2, processing_res=0, noise="gaussian", seed=3, color_map=None)
    want = tp(image, batch_size=1, **kw)
    try:
        tp.with_mesh(parallel.make_mesh(devices=["cpu", "cpu"]))._replicas[1] = tp._replica_on(torch.device("cpu"))
        got = tp(image, batch_size=2, **kw)
    finally:
        tp.with_mesh(None)
    assert len(members) == 2 and torch.equal(members[0], members[1])
    np.testing.assert_array_equal(got.depth_np, want.depth_np)
    np.testing.assert_array_equal(got.uncertainty, want.uncertainty)
    assert parallel.make_train_mesh(devices=["cpu"] * 4, fsdp=2).shape == {"data": 2, "fsdp": 2}
    with pytest.raises(ValueError, match="not divisible by fsdp=3"):
        parallel.make_train_mesh(devices=["cpu", "cpu"], fsdp=3)


def test_unported_options_raise(monkeypatch, pipes, image):
    """The options that raised before slice C now run and match the JAX
    package: an ensemble (of zeros-noise members, so identical draws in both)
    with its uncertainty, and a gaussian-noise member (the JAX draw fed to the
    port)."""
    jp, tp = pipes
    kw = dict(processing_res=64, color_map=None, seed=0)
    want, got = jp(image, ensemble_size=2, batch_size=1, **kw), tp(image, ensemble_size=2, **kw)
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=ENSEMBLE_DRIFT, rtol=0)
    assert got.uncertainty.shape == want.uncertainty.shape == (64, 48)
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, atol=ENSEMBLE_DRIFT, rtol=0)
    want = jp(image, noise="gaussian", **kw)
    feed_draws(monkeypatch, jax_member_latents("gaussian", 0, 1))
    got = tp(image, noise="gaussian", **kw)
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=1e-3, rtol=0)


@pytest.mark.parametrize("kind", ["ddim", "ddpm", "lcm"])
def test_multi_step_device_body_matches(scheduler_pipes, rgb, kind):
    """Three steps of each scheduler from a pyramid latent, given the JAX
    draws: the step noise of the batch-1 chunk at member 0."""
    jp, tp = scheduler_pipes[kind]
    latent0 = np.array(jnoise.make_noise("pyramid", jax.random.key(SEED + 1), LATENT, jnp.float32))
    key = jax.random.fold_in(jax.random.key(SEED), 0)
    want = np.asarray(jp._infer_jit(jp.params, jnp.asarray(rgb), STEPS, False, jnp.asarray(latent0), key))
    assert tp.step_noises(STEPS) == (0 if kind == "ddim" else STEPS)
    step_noise = [nchw(np.array(jax.random.normal(k, LATENT, jnp.float32))) for k in jax.random.split(key, STEPS)]
    got = tp.infer(torch.from_numpy(rgb), STEPS, False, nchw(latent0), step_noise if kind != "ddim" else None)
    assert got.shape == (1, 64, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    if kind != "ddim":
        with pytest.raises(ValueError, match="step_noise"):
            tp.infer(torch.from_numpy(rgb), STEPS, False, nchw(latent0))


@pytest.mark.parametrize("normals", [False, True], ids=["depth", "normals"])
def test_call_ensemble_matches(monkeypatch, pipes, image, normals):
    """A 3-member pyramid-noise ensemble at 3 DDIM steps: JAX in batch-1
    chunks, the port in chunks of 2 and 1, fed the JAX members' latents."""
    jp, tp = pipes
    kw = dict(processing_res=64, denoising_steps=STEPS, ensemble_size=3, noise="pyramid", seed=SEED, color_map=None,
              normals=normals)
    name = "ensemble_normals" if normals else "ensemble_depths"
    want_members = record(monkeypatch, jens, name)
    want = jp(image, batch_size=1, **kw)
    feed_draws(monkeypatch, jax_member_latents("pyramid", SEED, 3))
    got_members = record(monkeypatch, tens, name)
    got = tp(image, batch_size=2, **kw)
    assert got_members[0].shape == want_members[0].shape == ((3, 64, 48, 3) if normals else (3, 64, 48))
    np.testing.assert_allclose(got_members[0], want_members[0], atol=MEMBER_BOUND[normals], rtol=0)
    if normals:  # the same member is picked
        np.testing.assert_allclose(got.normal_np, want.normal_np, atol=MEMBER_BOUND[normals], rtol=0)
        assert got.uncertainty is None and want.uncertainty is None
        return
    np.testing.assert_allclose(got.depth_np, want.depth_np, atol=ENSEMBLE_DRIFT, rtol=0)
    assert got.uncertainty.shape == want.uncertainty.shape == (64, 48)
    np.testing.assert_allclose(got.uncertainty, want.uncertainty, atol=ENSEMBLE_DRIFT, rtol=0)


@pytest.mark.parametrize("kind", ["ddim", "lcm"])
def test_seed_gives_the_same_bits(scheduler_pipes, image, kind):
    """The port's own draws: the same seed twice gives the same output, bit
    for bit; another seed another output."""
    _, tp = scheduler_pipes[kind]
    kw = dict(processing_res=64, denoising_steps=2, ensemble_size=3, noise="pyramid", batch_size=2, color_map=None)
    a, b = tp(image, seed=3, **kw), tp(image, seed=3, **kw)
    np.testing.assert_array_equal(a.depth_np, b.depth_np)
    np.testing.assert_array_equal(a.uncertainty, b.uncertainty)
    assert not np.array_equal(a.depth_np, tp(image, seed=4, **kw).depth_np)


def test_lcm_checkpoint_loads_as_lcm(tmp_path, checkpoint):
    """A directory whose scheduler is an `LCMScheduler` with non-default
    distillation fields loads as `scheduler_type="lcm"` with those fields in
    both packages."""
    import os
    import shutil

    path = str(tmp_path / "lcm")
    shutil.copytree(checkpoint, path)
    cfg = jsched.SchedulerConfig(original_inference_steps=25, timestep_scaling=5.0)
    with open(os.path.join(path, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(jloading.scheduler_config_to_hf(cfg, "LCMScheduler"), f)
    jp, tp = jloading.load_marigold_pipeline(path), tloading.load_marigold_pipeline(path, device="cpu")
    assert jp.scheduler_type == tp.scheduler_type == "lcm"
    assert dataclasses.asdict(tp.scheduler_config) == dataclasses.asdict(jp.scheduler_config)
    assert tp.scheduler_config.original_inference_steps == 25 and tp.scheduler_config.timestep_scaling == 5.0


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
