"""The torch port's E2E train step against the JAX package's `E2ETrainer` on the
CPU, fp32, with the same seeded weights (through the port's converter) and
the same numpy batches: the LR schedule, the config's JSON form, one step's
loss and every gradient leaf (depth and normals, with and without UNet
checkpointing; gaussian noise), the parameters and EMA after two optimizer steps with K=1 and
K=2 micro-steps (optax's clip, AdamW and MultiSteps semantics), the
all-invalid mask, `fused_vae_kernels` on the CPU (against the plain path and
against the JAX trainer's fused VAE), and the config check (slice D3's
options run: `tests/test_torch_trainer_options.py`).

Models are cut to two UNet levels and two VAE levels so the JAX side's jit
compiles stay short. Tolerances: the loss 1e-5 relative, each gradient leaf
1e-4 * max(1, max |g|) (fp32 summation order through two networks), the
parameters after the updates 1e-6 (with adam_epsilon=1e-3: at 1e-8, Adam's
first step is about lr * sign(g), and float noise in near-zero gradients
would flip whole updates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, random_flax_params
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.training import E2ETrainer as JTrainer, TrainConfig as JConfig
from diffusion_e2e_ft_tpu.training.lr import iter_exponential_schedule as j_schedule
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import convert as tconvert
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
from diffusion_e2e_ft_tpu_torch.training.lr import iter_exponential_schedule
from diffusion_e2e_ft_tpu_torch.training.trainer import check_ported

UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
B, H, W = 2, 48, 64  # latent 6 x 8: H != W catches a transposed layout


@pytest.fixture(scope="module")
def weights():
    up = random_flax_params(JUNet(JUNetConfig.tiny(**UNET)), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999),
                            jnp.ones((1, 2, 32)))
    vp = random_flax_params(JVAE(JVAEConfig(**VAE)), 1, jnp.ones((1, 32, 32, 3)))
    empty = np.random.default_rng(2).normal(size=(1, 2, 32)).astype(np.float32)
    return up, vp, empty


def make_batch(modality, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"rgb": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32), "val_mask": rng.random((B, H, W)) > 0.2}
    if modality == "depth":
        batch["target"] = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    else:
        n = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        batch["target"] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return batch


def trainers(weights, **cfg):
    """(JAX trainer, JAX UNet params, port trainer) on the same weights."""
    up, vp, empty = weights
    jt = JTrainer(JConfig(**cfg), JUNet(JUNetConfig.tiny(**UNET)), JVAE(JVAEConfig(**VAE)), vp, empty)
    unet = load_into(UNet2DCondition(UNetConfig.tiny(**UNET)), up)
    vae = load_into(AutoencoderKL(VAEConfig(**VAE)), vp)
    return jt, up, E2ETrainer(TrainConfig(**cfg), unet, vae, empty)


def state_dict(flax_tree):
    return {k: torch.from_numpy(v) for k, v in tconvert.flax_params_to_state_dict(jax.tree.map(np.array, flax_tree)).items()}


def test_lr_schedule_matches():
    for args in ((3e-5, 1000, 0.01, 100), (1e-3, 10, 0.1, 0), (1.0, 50, 0.01, 1)):
        want, got = j_schedule(*args), iter_exponential_schedule(*args)
        for step in (0, 1, 2, 5, 49, 50, 99, 100, 101, 550, 999, 1000, 5000):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0)
    assert iter_exponential_schedule(3e-5, 1000, 0.01, 100)(0) == 0.0  # warmup starts at lr 0


def test_config_json_round_trip():
    port = TrainConfig(modality="normals", gradient_accumulation_steps=4, checkpoints_total_limit=3)
    assert JConfig.from_json(port.to_json()) == JConfig(**vars(port))
    assert TrainConfig.from_json(JConfig().to_json()) == TrainConfig()
    assert TrainConfig.from_json(port.to_json()) == port


@pytest.mark.parametrize("checkpointing", [False, True], ids=["plain", "checkpointed"])
@pytest.mark.parametrize("modality", ["depth", "normals"])
def test_loss_and_grads_match_jax(weights, modality, checkpointing):
    cfg = dict(modality=modality, gradient_checkpointing=checkpointing, fused_vae_kernels=False,
               gradient_accumulation_steps=1)
    jt, up, pt = trainers(weights, **cfg)
    batch = make_batch(modality, seed=3)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        up, jt._frozen(), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0)
    )
    loss, _, grads = pt.value_and_grad(batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grads = state_dict(want_grads)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        w = want_grads[name]
        assert g.shape == w.shape, name
        bound = 1e-4 * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound, name


@pytest.mark.parametrize("accum", [1, 2], ids=["K1", "K2"])
def test_params_after_two_optimizer_steps_match_jax(weights, accum):
    """Two optimizer steps (K micro-steps each) through both trainers: clipping
    active (max_grad_norm 0.05), warmup of one step (lr(0) = 0), the empty
    class-embedding LR group, and EMA on synced steps only."""
    cfg = dict(gradient_accumulation_steps=accum, gradient_checkpointing=False, fused_vae_kernels=False,
               learning_rate=1e-3, lr_warmup_steps=1, lr_total_iter_length=10, max_grad_norm=0.05,
               adam_epsilon=1e-3, use_ema=True, ema_decay=0.9)
    jt, up, pt = trainers(weights, **cfg)
    jstate, state = jt.init_state(up), pt.init_state()
    initial = {n: p.detach().clone() for n, p in state.params.items()}
    for micro in range(2 * accum):
        batch = make_batch("depth", seed=10 + micro)
        jstate, jm = jt.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(micro))
        state, m = pt.train_step(state, batch)
        assert (state.step, state.micro_step, m["lr_step"]) == (int(jstate.step), micro + 1, int(jm["lr_step"]))
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        if accum == 2 and micro == 0:  # between syncs nothing moves
            assert all(torch.equal(state.params[n], initial[n]) for n in initial)
    assert state.step == 2
    for tree, port in ((jstate.params, state.params), (jstate.ema_params, state.ema_params)):
        want = state_dict(tree)
        for name, p in port.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    assert max(float((state.params[n].detach() - initial[n]).abs().max()) for n in initial) > 1e-4  # it trained


def test_gaussian_noise_loss_and_grads_match_jax(weights):
    """Non-zero noise through x0 recovery: the noise latent the JAX trainer
    draws from its key, fed to the port (the streams differ; the draws, the
    pyramid's included, are held in tests/test_torch_noise.py)."""
    cfg = dict(noise_type="gaussian", gradient_checkpointing=False, fused_vae_kernels=False,
               gradient_accumulation_steps=1)
    jt, up, pt = trainers(weights, **cfg)
    batch = make_batch("depth", seed=6)
    key = jax.random.key(3)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        up, jt._frozen(), {k: jnp.asarray(v) for k, v in batch.items()}, key
    )
    noise = np.array(jt._make_noisy_latents(key, (B, H // 2, W // 2, 4)))  # the two-level VAE: 2x
    assert np.abs(noise).max() > 0
    loss, _, grads = pt.value_and_grad(batch, noise=torch.from_numpy(np.ascontiguousarray(np.moveaxis(noise, -1, 1))))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grads = state_dict(want_grads)
    for name, g in grads.items():
        bound = 1e-4 * max(1.0, float(want_grads[name].abs().max()))
        assert float((g - want_grads[name]).abs().max()) <= bound, name


def test_all_invalid_mask_zero_loss_no_nan(weights):
    _, _, pt = trainers(weights, gradient_accumulation_steps=1, fused_vae_kernels=False, lr_warmup_steps=0)
    batch = make_batch("depth")
    batch["val_mask"] = np.zeros_like(batch["val_mask"])
    state, m = pt.train_step(pt.init_state(), batch)
    assert float(m["loss"]) == 0.0 and float(m["grad_norm"]) == 0.0
    assert all(torch.isfinite(p).all() for p in state.params.values())


def test_fused_vae_kernels_on_cpu_matches_plain(weights):
    """On the CPU, as in the JAX package off the TPU, fused_vae_kernels=True runs
    the plain GroupNorm -> SiLU -> conv composite: the same loss and gradients."""
    batch = make_batch("normals", seed=5)
    out = []
    for fused in (True, False):
        _, _, pt = trainers(weights, modality="normals", fused_vae_kernels=fused, gradient_checkpointing=False)
        out.append(pt.value_and_grad(batch))
    assert float(out[0][0]) == float(out[1][0])
    assert all(torch.equal(out[0][2][n], out[1][2][n]) for n in out[0][2])


def test_fused_vae_loss_and_grads_match_jax(weights):
    """Both trainers with fused_vae_kernels=True (their default): the JAX one
    builds a fused_gn_conv VAE, the port its own fused module over the same
    weights; off the TPU and the card both run the plain composite."""
    cfg = dict(modality="depth", gradient_checkpointing=False, fused_vae_kernels=True, gradient_accumulation_steps=1)
    jt, up, pt = trainers(weights, **cfg)
    assert jt.vae.config.fused_gn_conv and pt.vae.config.fused_gn_conv
    batch = make_batch("depth", seed=4)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        up, jt._frozen(), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0)
    )
    loss, _, grads = pt.value_and_grad(batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grads = state_dict(want_grads)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        bound = 1e-4 * max(1.0, float(want_grads[name].abs().max()))
        assert float((g - want_grads[name]).abs().max()) <= bound, name


def test_trainer_leaves_callers_vae_unchanged(weights):
    """The trainer's fused VAE is a module of its own over the caller's
    weights: the caller's config, mode and requires_grad stay as they were."""
    _, vp, _ = weights
    vae = load_into(AutoencoderKL(VAEConfig(**VAE)), vp).train()
    before = {n: p.detach().clone() for n, p in vae.named_parameters()}
    _, _, pt = trainers(weights, fused_vae_kernels=True)
    pt = E2ETrainer(pt.config, pt.unet, vae, weights[2])
    assert pt.vae is not vae and pt.vae.config.fused_gn_conv and not vae.config.fused_gn_conv
    assert vae.training and all(p.requires_grad for p in vae.parameters())
    assert not pt.vae.training and not any(p.requires_grad for p in pt.vae.parameters())
    for name, p in pt.vae.named_parameters():  # the same storage on the same device
        assert p.data_ptr() == dict(vae.named_parameters())[name].data_ptr()
        assert torch.equal(p, before[name])


@pytest.mark.parametrize(
    "override,device,error,match",
    [
        (dict(noise_type="gaussian"), "cpu", None, None),  # ported with the trainers' noise: no error
        (dict(noise_type="pyramid"), "cpu", None, None),
        (dict(adam_mu_dtype="bfloat16"), "cpu", None, None),  # slice D3 is ported: no error
        (dict(remat_policy="dots"), "cpu", None, None),
        (dict(modality="joint"), "cpu", ValueError, "GeoWizardTrainer"),  # the joint trainer's modality
        (dict(fused_vae_kernels=True), "cuda", None, None),  # slice D2 is ported: no error
        (dict(modality="segmentation"), "cpu", ValueError, "Unknown modality"),
    ],
    ids=["gaussian", "pyramid", "mu-dtype", "remat-policy", "joint", "fused-on-cuda", "unknown-modality"],
)
def test_unported_options_raise(override, device, error, match):
    config = TrainConfig(fused_vae_kernels=False).replace(**override)
    if error is None:
        check_ported(config, torch.device(device))
        return
    with pytest.raises(error, match=match):
        check_ported(config, torch.device(device))


def test_default_config_runs_on_cpu():
    check_ported(TrainConfig(), torch.device("cpu"))  # fused_vae_kernels=True is the plain path here


def test_default_config_is_ported_on_cuda():
    """fused_vae_kernels=True (the default) runs the fused kernels on the card;
    the check needs no card."""
    check_ported(TrainConfig(), torch.device("cuda"))
