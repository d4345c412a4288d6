"""Slice B2 as a whole: the torch port's GeoWizard joint trainer against the
JAX package's `GeoWizardTrainer` on the CPU, fp32, with one seeded param set
(UNet with the class embedding and joint attention, VAE, CLIP vision tower)
through the port's converters and the same numpy batches: `latent_valid_mask`,
one step's loss, per-loss metrics and every gradient leaf in E2E and
diffusion-loss modes with zeros and gaussian noise (the JAX t and noise taken
from the JAX key and fed to the port), the parameters after two optimizer
steps (the 10x class-embedding LR group), the all-invalid batch, the loop's
seeded generator, the joint export and `cli.train --modality joint`, whose
export loads in both packages.

Models are cut to two UNet levels at tiny widths so the JAX side's jit
compiles stay short. Tolerances as `test_torch_train_step.py`: the loss and
the per-loss metrics 1e-5 relative, each gradient leaf 1e-4 * max(1, max |g|),
the parameters after the updates 1e-6 (adam_epsilon=1e-3)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import geowizard_flax_params, load_geowizard_into
from test_cli_train import make_hypersim_tree, make_vkitti_tree
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.ops import scheduler as jsched
from diffusion_e2e_ft_tpu.pipelines import loading as jloading
from diffusion_e2e_ft_tpu.training import GeoWizardTrainer as JGeoTrainer, TrainConfig as JConfig
from diffusion_e2e_ft_tpu.training.geowizard import latent_valid_mask as j_latent_valid_mask
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip as tclip
from diffusion_e2e_ft_tpu_torch.models import convert as tconvert
from diffusion_e2e_ft_tpu_torch.pipelines import loading as tloading
from diffusion_e2e_ft_tpu_torch.training import GeoWizardTrainer, TrainConfig
from diffusion_e2e_ft_tpu_torch.training import checkpoints as C
from diffusion_e2e_ft_tpu_torch.training.geowizard import latent_valid_mask
from diffusion_e2e_ft_tpu_torch.training.loop import run_training
from diffusion_e2e_ft_tpu_torch.training.trainer import check_ported

UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1, cross_attention_dim=32)
VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)  # 8x: the latent mask's
VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, image_size=224, patch_size=32,
              projection_dim=32)
B, H, W = 2, 48, 64  # latent 6 x 8: H != W catches a transposed layout


@pytest.fixture(scope="module")
def params():
    return geowizard_flax_params(JUNetConfig.geowizard(**UNET), JVAEConfig(**VAE), jclip.CLIPVisionConfig(**VISION),
                                 seed=20)


def make_batch(seed=0, invalid=True):
    """Unit normals, depth in [-1, 1], a domain, and a mask with one invalid
    block (so some latent cells stay valid) plus scattered invalid pixels."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    mask = np.ones((B, H, W), bool)
    if invalid:
        mask[0, :16, :24] = False
        mask[1, 20:, 40:] = rng.random((H - 20, W - 40)) > 0.3
    return {"rgb": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32),
            "depth_target": rng.uniform(-1, 1, (B, H, W)).astype(np.float32),
            "normal_target": n / np.linalg.norm(n, axis=-1, keepdims=True), "val_mask": mask,
            "domain": np.array([0.0, 1.0, 0.0], np.float32)}


def trainers(params, **cfg):
    """(JAX trainer, JAX UNet params, port trainer) on the same weights."""
    jt = JGeoTrainer(JConfig(**cfg), JUNet(JUNetConfig.geowizard(**UNET)), JVAE(JVAEConfig(**VAE)), params["vae"],
                     jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**VISION)), params["image_encoder"])
    unet, vae, encoder = load_geowizard_into(
        UNet2DCondition(UNetConfig.geowizard(**UNET)), AutoencoderKL(VAEConfig(**VAE)),
        tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig(**VISION)), params)
    return jt, params["unet"], GeoWizardTrainer(TrainConfig(**cfg), unet, vae, encoder)


def state_dict(flax_tree):
    return {k: torch.from_numpy(v)
            for k, v in tconvert.flax_params_to_state_dict(jax.tree.map(np.array, flax_tree)).items()}


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.array(x), -1, 1)))


def jax_draws(jt, key, e2e):
    """The t and noise latent the JAX `_loss` takes from its key, in its order."""
    key_t, key_n = jax.random.split(key)
    if e2e:
        t2 = jnp.full((2 * B,), 999, jnp.int32)
        return None, jt._make_noisy_latents(key_n, (2 * B, H // 8, W // 8, 4), timesteps=t2)
    t = jax.random.randint(key_t, (B,), 0, jt.scheduler_config.num_train_timesteps)
    return t, jt._make_noisy_latents(key_n, (2 * B, H // 8, W // 8, 4), timesteps=jnp.concatenate([t, t]))


@pytest.mark.parametrize("seed", [0, 1])
def test_latent_valid_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((3, 40, 56)) > 0.02  # most 8x8 cells hold an invalid pixel, not all
    mask[1] = True
    mask[2, :, :17] = False
    want = np.asarray(j_latent_valid_mask(jnp.asarray(mask)))
    got = latent_valid_mask(torch.from_numpy(mask))
    assert got.shape == (3, 5, 7) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].all() and not got[2, :, :3].any() and got.any() and not got.all()


@pytest.mark.parametrize("noise_type", ["zeros", "gaussian"])
@pytest.mark.parametrize("e2e", [True, False], ids=["e2e", "diffusion"])
def test_loss_and_grads_match_jax(params, e2e, noise_type):
    """`GeoWizardTrainer.loss` against `jax.value_and_grad(GeoWizardTrainer._loss)`."""
    cfg = dict(e2e=e2e, noise_type=noise_type, gradient_checkpointing=not e2e, fused_vae_kernels=False,
               gradient_accumulation_steps=1)
    jt, up, pt = trainers(params, **cfg)
    batch = make_batch(seed=3)
    key = jax.random.key(5)
    (want_loss, want_metrics), want_grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        up, jt._frozen(), {k: jnp.asarray(v) for k, v in batch.items()}, key
    )
    t, noise = jax_draws(jt, key, e2e)
    explicit = {"noise": nchw(noise)}
    if t is not None:
        explicit["timesteps"] = torch.from_numpy(np.array(t))
    loss, metrics, grads = pt.value_and_grad(batch, **explicit)
    assert float(want_loss) > 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(metrics) == set(want_metrics) == ({"loss", "loss_ssi", "loss_angular"} if e2e else {"loss"})
    for name in metrics:
        np.testing.assert_allclose(float(metrics[name]), float(want_metrics[name]), rtol=1e-5, err_msg=name)
    want_grads = state_dict(want_grads)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        w = want_grads[name]
        assert g.shape == w.shape, name
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound, name
    assert float(grads["class_embedding.linear_1.weight"].abs().max()) > 0


def test_params_after_two_optimizer_steps_match_jax(params):
    """Two optimizer steps through both trainers: clipping active per group
    (max_grad_norm 0.05), a one-step warmup, and the class embedding's 10x LR
    group (`class_embedding_lr_mult`, the default 10)."""
    cfg = dict(gradient_accumulation_steps=1, gradient_checkpointing=False, fused_vae_kernels=False,
               learning_rate=1e-3, lr_warmup_steps=1, lr_total_iter_length=10, max_grad_norm=0.05,
               adam_epsilon=1e-3)
    jt, up, pt = trainers(params, **cfg)
    assert pt.config.class_embedding_lr_mult == jt.config.class_embedding_lr_mult == 10.0
    jstate, state = jt.init_state(up), pt.init_state()
    initial = {n: p.detach().clone() for n, p in state.params.items()}
    for micro in range(2):
        batch = make_batch(seed=10 + micro)
        jstate, jm = jt.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(micro))
        state, m = pt.train_step(state, batch)
        assert (state.step, m["lr_step"]) == (int(jstate.step), int(jm["lr_step"]))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["loss_angular"]), float(jm["loss_angular"]), rtol=1e-5)
    want = state_dict(jstate.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    moved = {n: float((state.params[n].detach() - initial[n]).abs().max()) for n in initial}
    assert moved["class_embedding.linear_1.weight"] > 1e-4 and max(moved.values()) > 1e-4  # it trained


@pytest.mark.parametrize("e2e", [True, False], ids=["e2e", "diffusion"])
def test_all_invalid_mask_zero_loss_no_nan(params, e2e):
    _, _, pt = trainers(params, e2e=e2e, gradient_accumulation_steps=1, fused_vae_kernels=False, lr_warmup_steps=0)
    batch = make_batch()
    batch["val_mask"] = np.zeros_like(batch["val_mask"])
    state, m = pt.train_step(pt.init_state(), batch, torch.Generator().manual_seed(0))
    assert float(m["loss"]) == 0.0 and float(m["grad_norm"]) == 0.0
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_joint_modality_belongs_to_the_geowizard_trainer(params):
    """The joint trainer passes `check_ported` with its own modalities and
    forces modality='joint', as the JAX trainer; the diffusion-loss mode draws t
    from the step's generator and raises without one."""
    check_ported(TrainConfig(modality="joint"), torch.device("cpu"), GeoWizardTrainer.MODALITIES)
    with pytest.raises(ValueError, match="Unknown modality"):
        check_ported(TrainConfig(modality="depth"), torch.device("cpu"), GeoWizardTrainer.MODALITIES)
    _, _, pt = trainers(params, modality="depth", e2e=False, fused_vae_kernels=False)
    assert pt.config.modality == "joint"
    with pytest.raises(ValueError, match="Generator"):
        pt.loss(make_batch())


def test_trainer_leaves_callers_image_encoder_unchanged(params):
    _, _, pt = trainers(params, fused_vae_kernels=False)
    encoder = tclip.CLIPVisionModelWithProjection(tclip.CLIPVisionConfig(**VISION)).train()
    pt = GeoWizardTrainer(pt.config, pt.unet, pt.vae, encoder)
    assert pt.image_encoder is not encoder and encoder.training and all(p.requires_grad for p in encoder.parameters())
    assert not pt.image_encoder.training and not any(p.requires_grad for p in pt.image_encoder.parameters())


def test_run_training_seeds_the_generator(params, tmp_path):
    """`run_training` draws every step's noise and t from a generator seeded
    with `config.seed`: the same seed trains the same weights, another does not."""
    out = []
    for seed in (0, 0, 1):
        _, _, pt = trainers(params, e2e=False, noise_type="pyramid", seed=seed, gradient_accumulation_steps=1,
                            gradient_checkpointing=False, fused_vae_kernels=False, lr_warmup_steps=0,
                            learning_rate=1e-3, max_train_steps=2, output_dir=str(tmp_path / f"run{len(out)}"))
        batches = [make_batch(seed=20 + i) for i in range(2)]
        state = run_training(pt, pt.init_state(), lambda epoch: batches, log_every=1)
        out.append({n: p.detach().clone() for n, p in state.params.items()})
    assert all(torch.equal(out[0][n], out[1][n]) for n in out[0])
    assert not all(torch.equal(out[0][n], out[2][n]) for n in out[0])


# the CLI's UNet attends at level 1 only: the synthetic trees' 480x640 and 352x1216 samples would
# put 9600 joint tokens through the plain CPU attention at level 0
CLI_UNET = dict(UNET, cross_attention_levels=(False, True))


@pytest.fixture(scope="module")
def joint_base_checkpoint(tmp_path_factory, params):
    """A GeoWizard HF checkpoint (image_encoder/ and a feature_extractor/), written by the JAX package."""
    path = tmp_path_factory.mktemp("geo_base")
    up = geowizard_flax_params(JUNetConfig.geowizard(**CLI_UNET), JVAEConfig(**VAE),
                               jclip.CLIPVisionConfig(**VISION), seed=21)["unet"]
    jloading.save_pipeline_dir(
        str(path), JUNetConfig.geowizard(**CLI_UNET), up, JVAEConfig(**VAE), params["vae"],
        jsched.SchedulerConfig(), scheduler_class="DDPMScheduler", pipeline_class="GeoWizardPipeline",
        image_encoder_config=jclip.CLIPVisionConfig(**VISION), image_encoder_params=params["image_encoder"],
    )
    os.makedirs(path / "feature_extractor")
    with open(path / "feature_extractor" / "preprocessor_config.json", "w") as f:
        json.dump({"crop_size": 224}, f)
    return str(path)


def test_joint_export_requires_the_image_tower(tmp_path, joint_base_checkpoint):
    assert set(tloading.frozen_tower_subfolders(joint_base_checkpoint, "joint")) == {"image_encoder",
                                                                                   "feature_extractor"}
    with pytest.raises(FileNotFoundError, match="text_encoder"):  # a depth export needs the text tower
        tloading.frozen_tower_subfolders(joint_base_checkpoint, "depth")
    with pytest.raises(FileNotFoundError, match="image_encoder"):
        tloading.frozen_tower_subfolders(str(tmp_path), "joint")


def test_cli_train_joint_end_to_end(tmp_path, joint_base_checkpoint, monkeypatch):
    """`cli.train --modality joint` on the synthetic Hypersim / VKITTI trees:
    two steps with joint attention, a checkpoint, and an export that carries
    the image tower and loads in both packages with the same weights."""
    from diffusion_e2e_ft_tpu_torch.cli import train as train_cli

    built = []
    init = GeoWizardTrainer.__init__

    def record(self, config, unet, *args, **kw):
        built.append(unet.config.joint_attention)
        init(self, config, unet, *args, **kw)

    monkeypatch.setattr(GeoWizardTrainer, "__init__", record)
    hyper_csv = make_hypersim_tree(tmp_path / "hypersim")
    make_vkitti_tree(tmp_path / "vkitti")
    out_dir = tmp_path / "run"
    train_cli.main([
        "--pretrained_model_name_or_path", joint_base_checkpoint,
        "--modality", "joint", "--noise_type", "pyramid",
        "--output_dir", str(out_dir),
        "--hypersim_root", str(tmp_path / "hypersim"), "--hypersim_split_csv", hyper_csv,
        "--vkitti_root", str(tmp_path / "vkitti"),
        "--train_batch_size", "1", "--gradient_accumulation_steps", "1", "--max_train_steps", "2",
        "--checkpointing_steps", "2", "--lr_warmup_steps", "0", "--seed", "0", "--device", "cpu",
    ])
    assert built == [True]  # GeoWizard trains with its cross-task attention
    assert [s for s, _ in C.list_checkpoints(str(out_dir))] == [2]
    export = str(out_dir / "export")
    index = json.load(open(os.path.join(export, "model_index.json")))
    assert index["_class_name"] == "GeoWizardPipeline"
    assert index["image_encoder"] == ["transformers", "CLIPVisionModelWithProjection"]
    assert os.path.isfile(os.path.join(export, "feature_extractor", "preprocessor_config.json"))
    assert json.load(open(os.path.join(export, "scheduler", "scheduler_config.json")))["timestep_spacing"] == \
        "trailing"
    trained = torch.load(os.path.join(str(out_dir), "checkpoint-2", "train_state.pt"), weights_only=True)["params"]

    tp = tloading.load_geowizard_pipeline(export, device="cpu")
    jp = jloading.load_geowizard_pipeline(export)
    assert tp.unet.config.joint_attention and jp.unet.config.joint_attention
    jsd = tconvert.flax_params_to_state_dict(jax.tree.map(np.array, jp.params["unet"]))
    for key, value in tp.unet.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), trained[key].detach().numpy(), err_msg=key)
        np.testing.assert_array_equal(jsd[key], value.numpy(), err_msg=key)
    jenc = tconvert.clip_vision_params_to_state_dict(jp.params["image_encoder"])
    for key, value in tp.image_encoder.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jenc[key]), value.numpy(), err_msg=key)
    out = tp(np.zeros((48, 64, 3), np.uint8), processing_res=0, color_map=None)
    assert np.isfinite(out.depth_np).all() and np.isfinite(out.normal_np).all()
