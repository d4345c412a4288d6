"""The torch port's training loop, checkpoints, export and CLI on the CPU: a few
steps of `run_training` with checkpoint rotation, logs, restore and resume,
the emergency checkpoint on a non-finite step; an HF export from the port
loading in the JAX package (and one from the JAX package loading in the
port) with the same depth to 1e-4 (the towers' fp32 summation-order bound);
and `cli.train` on the synthetic Hypersim / VKITTI trees of
`tests/test_cli_train.py`."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, random_flax_params
from test_cli_train import make_hypersim_tree, make_vkitti_tree
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.ops import scheduler as jsched
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu.training import checkpoints as jckpt
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.ops import scheduler as tsched
from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
from diffusion_e2e_ft_tpu_torch.training import checkpoints as C
from diffusion_e2e_ft_tpu_torch.training.loop import run_training

UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1)
VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)  # 8x, as the pipelines assume
TEXT = dict(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64)


def _flax(in_channels=8):
    up = random_flax_params(JUNet(JUNetConfig.tiny(in_channels=in_channels, **UNET)), 0,
                            jnp.ones((1, 8, 8, in_channels)), jnp.asarray(999), jnp.ones((1, 2, 32)))
    return up, random_flax_params(JVAE(JVAEConfig(**VAE)), 1, jnp.ones((1, 32, 32, 3)))


def _trainer(tmp_path, max_steps, **cfg):
    up, vp = _flax()
    config = TrainConfig(gradient_accumulation_steps=1, gradient_checkpointing=False, fused_vae_kernels=False,
                         max_train_steps=max_steps, checkpointing_steps=2, checkpoints_total_limit=1,
                         lr_warmup_steps=0, learning_rate=1e-3, output_dir=str(tmp_path / "run"), **cfg)
    unet = load_into(UNet2DCondition(UNetConfig.tiny(**UNET)), up)
    vae = load_into(AutoencoderKL(VAEConfig(**VAE)), vp)
    return E2ETrainer(config, unet, vae, np.zeros((1, 2, 32), np.float32))


def _epochs(b=2, h=32, w=32):
    rng = np.random.default_rng(0)
    batches = [
        {
            "rgb": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "target": rng.uniform(-1, 1, (b, h, w)).astype(np.float32),
            "val_mask": np.ones((b, h, w), bool),
        }
        for _ in range(4)
    ]
    return lambda epoch: list(batches)


def _copy(params):
    return {n: p.detach().clone() for n, p in params.items()}


def test_runs_rotates_checkpoints_and_logs(tmp_path):
    trainer = _trainer(tmp_path, max_steps=3, use_ema=True)
    final = run_training(trainer, trainer.init_state(), _epochs(), log_every=1)
    assert (final.step, final.micro_step) == (3, 3)
    out = trainer.config.output_dir
    assert [s for s, _ in C.list_checkpoints(out)] == [2]  # rotation kept the latest only
    assert C.latest_checkpoint(out).endswith("checkpoint-2") and C.step_from_path(C.latest_checkpoint(out)) == 2
    lines = open(os.path.join(out, "logs", "metrics.jsonl")).read().splitlines()
    assert len(lines) == 3 and np.isfinite(json.loads(lines[-1])["train_loss"])
    assert os.path.exists(os.path.join(out, "arguments.txt"))


def test_restore_is_exact_and_resume_continues(tmp_path):
    trainer = _trainer(tmp_path, max_steps=2, use_ema=True)
    state = run_training(trainer, trainer.init_state(), _epochs())
    saved = (_copy(state.params), _copy(state.opt_state["mu"]), _copy(state.ema_params), state.opt_state["count"])

    # a fresh trainer restores the step-2 checkpoint into its own tensors exactly
    fresh = _trainer(tmp_path, max_steps=4, use_ema=True)
    restored = C.restore_checkpoint(C.latest_checkpoint(fresh.config.output_dir), fresh.init_state())
    assert (restored.step, restored.micro_step, restored.opt_state["count"]) == (2, 2, saved[3])
    for got, want in ((restored.params, saved[0]), (restored.opt_state["mu"], saved[1]),
                      (restored.ema_params, saved[2])):
        assert all(torch.equal(got[n], want[n]) for n in want)
    assert all(p is restored.params[n] for n, p in fresh.unet.named_parameters())  # the module took the weights

    # ... and run_training resumes from it up to the new budget
    resumed = _trainer(tmp_path, max_steps=4, use_ema=True)
    final = run_training(resumed, resumed.init_state(), _epochs(), resume_from="latest")
    assert final.step == 4
    assert max(float((final.params[n].detach() - saved[0][n]).abs().max()) for n in saved[0]) > 0.0


def test_non_finite_step_saves_and_raises(tmp_path):
    trainer = _trainer(tmp_path, max_steps=3)
    with torch.no_grad():
        for p in trainer.unet.parameters():
            p.mul_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite"):
        run_training(trainer, trainer.init_state(), _epochs(), log_every=1)
    assert C.list_checkpoints(trainer.config.output_dir)  # the emergency save exists


@pytest.fixture(scope="module")
def base_checkpoint(tmp_path_factory):
    """A tiny raw-SD2-style HF checkpoint (4-channel conv_in) with a text tower, written by the JAX package."""
    path = tmp_path_factory.mktemp("base")
    up, vp = _flax(in_channels=4)
    jloading.save_pipeline_dir(str(path), JUNetConfig.tiny(in_channels=4, **UNET), up, JVAEConfig(**VAE), vp,
                               jsched.SchedulerConfig(), scheduler_class="DDPMScheduler")
    tcfg = jclip.CLIPTextConfig(**TEXT)
    tp = random_flax_params(jclip.CLIPTextModel(tcfg), 2, jnp.ones((1, 2), jnp.int32))
    jloading.save_text_encoder(str(path / "text_encoder"), tcfg, tp)
    return str(path)


def _depth_bodies(export_dir):
    """The device body's depth on one image, through each package's loader."""
    rgb = np.random.default_rng(3).uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    jp = jloading.load_marigold_pipeline(export_dir)
    want = np.asarray(jp._infer_jit(jp.params, jnp.asarray(rgb), 1, False, jnp.zeros((1, 6, 8, 4)),
                                    jax.random.key(0)))
    got = MarigoldPipeline.from_hf_dir(export_dir, device="cpu").infer(torch.from_numpy(rgb)).numpy()
    return got, want


@pytest.mark.parametrize("exporter", ["port", "jax"])
def test_export_loads_in_both_packages(tmp_path, base_checkpoint, exporter):
    up, vp = _flax()
    export = str(tmp_path / "export")
    if exporter == "port":
        unet = load_into(UNet2DCondition(UNetConfig.tiny(**UNET)), up)
        vae = load_into(AutoencoderKL(VAEConfig(**VAE)), vp)
        C.export_hf_pipeline(export, unet.config, dict(unet.named_parameters()), vae.config, vae.state_dict(),
                             tsched.SchedulerConfig(timestep_spacing="leading"), source_checkpoint=base_checkpoint)
    else:
        jckpt.export_hf_pipeline(export, JUNetConfig.tiny(**UNET), up, JVAEConfig(**VAE), vp,
                                 jsched.SchedulerConfig(timestep_spacing="leading"), source_checkpoint=base_checkpoint)
    sched = json.load(open(os.path.join(export, "scheduler", "scheduler_config.json")))
    assert sched["timestep_spacing"] == "trailing" and sched["_class_name"] == "DDPMScheduler"
    assert os.path.isdir(os.path.join(export, "text_encoder"))
    got, want = _depth_bodies(export)
    assert got.shape == want.shape == (1, 48, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cli_train_end_to_end(tmp_path, base_checkpoint):
    from diffusion_e2e_ft_tpu_torch.cli import train as train_cli

    hyper_csv = make_hypersim_tree(tmp_path / "hypersim")
    make_vkitti_tree(tmp_path / "vkitti")
    out_dir = tmp_path / "run"
    train_cli.main([
        "--pretrained_model_name_or_path", base_checkpoint,
        "--modality", "depth", "--noise_type", "zeros",
        "--output_dir", str(out_dir),
        "--hypersim_root", str(tmp_path / "hypersim"), "--hypersim_split_csv", hyper_csv,
        "--vkitti_root", str(tmp_path / "vkitti"),
        "--train_batch_size", "1", "--gradient_accumulation_steps", "1", "--max_train_steps", "2",
        "--checkpointing_steps", "2", "--lr_warmup_steps", "0", "--seed", "0", "--device", "cpu",
    ])
    assert [s for s, _ in C.list_checkpoints(str(out_dir))] == [2]
    export = out_dir / "export"
    assert json.load(open(export / "unet" / "config.json"))["in_channels"] == 8  # conv_in surgery
    assert json.load(open(export / "scheduler" / "scheduler_config.json"))["timestep_spacing"] == "trailing"
    assert json.load(open(export / "model_index.json"))["text_encoder"] == ["transformers", "CLIPTextModel"]
    pipe = MarigoldPipeline.from_hf_dir(str(export), device="cpu")
    assert float(pipe.empty_text_embed.abs().sum()) > 0  # the real text tower travelled with the export
    out = pipe(np.zeros((48, 64, 3), np.uint8), processing_res=0, color_map=None)
    assert np.isfinite(out.depth_np).all()
    # the export's DDPM class samples ancestrally at two steps and more: finite, and the JAX pipeline's
    # output on the same export given its draws (the step noise its body draws from the key), to 1e-4
    rgb = np.random.default_rng(3).uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    jp = jloading.load_marigold_pipeline(str(export))
    assert jp.scheduler_type == pipe.scheduler_type == "ddpm"
    key = jax.random.key(0)
    want = np.asarray(jp._infer_jit(jp.params, jnp.asarray(rgb), 2, False, jnp.zeros((1, 6, 8, 4)), key))
    noise = [torch.from_numpy(np.moveaxis(np.array(jax.random.normal(k, (1, 6, 8, 4), jnp.float32)), -1, 1).copy())
             for k in jax.random.split(key, 2)]
    got = pipe.infer(torch.from_numpy(rgb), num_steps=2, step_noise=noise).numpy()
    assert got.shape == (1, 48, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# --num_devices is ported (slice F): the CLI resolves the ranks it starts, CPU ranks here; more than the host
# can take raise (`tests/test_torch_parallel.py` trains two ranks end to end)
@pytest.mark.parametrize("argv,world", [(["--modality", "joint", "--num_devices", "2"], 2),
                                        (["--num_devices", "2"], 2)], ids=["argv0-slice F", "argv1-slice F"])
def test_cli_unported_options_raise(argv, world):
    from diffusion_e2e_ft_tpu_torch.cli import train as train_cli

    args = train_cli.build_parser().parse_args(["--pretrained_model_name_or_path", "unused", "--device", "cpu",
                                                *argv])
    assert train_cli.data_parallel_world(args) == world
    args.num_devices = None  # every visible device of the kind: the one CPU
    assert train_cli.data_parallel_world(args) == 1
    args.num_devices = (os.cpu_count() or 1) + 1
    with pytest.raises(ValueError, match="num_devices"):
        train_cli.data_parallel_world(args)
