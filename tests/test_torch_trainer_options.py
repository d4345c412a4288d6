"""Slice D3 on the CPU: the trainers' last options against the JAX package.

- `adam_mu_dtype="bfloat16"`: the port's optimizer against the JAX trainer's
  optax chain (`optax.adamw(mu_dtype=jnp.bfloat16)` under clipping,
  `MultiSteps`, and either one chain or the 10x class-embedding group),
  jitted as the JAX trainer's step is, six micro-steps of seeded gradients
  at K = 2: the stored moments to the bit, the parameters to 1e-6; the
  fp32-moment optimizer is off by more than that, so the bound has teeth.
  The trainer keeps its moment in bf16 and trains.
- `remat_policy` "dots" / "dots_all": the gradients equal the no-checkpoint
  gradients (1e-6 of each leaf's max), the loss equals the JAX trainer's
  with the same policy (1e-5 relative), and the recompute skips exactly
  the products the policy saves: counted in the backward pass, "dots"
  re-runs no `mm` / `addmm` of the forward, "dots_all" also no `bmm`, and
  both re-run every convolution.
- `VAEConfig.subpixel_upsample`: the port's decoder against the JAX
  decoder with the flag to 3e-5 (the bound of `tests/test_subpixel_upsample.py`)
  and against its own resize path; odd targets keep the resize; the
  parameter names do not change; the trainer's frozen VAE keeps the flag.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import load_into, nchw, random_flax_params
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.training import E2ETrainer as JTrainer, TrainConfig as JConfig
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models.layers import Upsample
from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, TrainConfig
from diffusion_e2e_ft_tpu_torch.training.lr import iter_exponential_schedule
from diffusion_e2e_ft_tpu_torch.training.optim import OptaxAdamW
from diffusion_e2e_ft_tpu_torch.training.trainer import check_ported

UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1)
VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
B, H, W = 2, 48, 64

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ops here are small: under the suite's parallel workers a thread
    pool per op costs far more than it gives, so this module runs on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# adam_mu_dtype
# ---------------------------------------------------------------------------

SHAPES = {"down.conv.weight": (6, 4, 3, 3), "down.conv.bias": (6,), "mid.proj.weight": (8, 6),
          "class_embedding.linear_1.weight": (5, 10), "class_embedding.linear_1.bias": (5,)}
OPT_CFG = dict(adam_mu_dtype="bfloat16", gradient_accumulation_steps=2,
               learning_rate=1e-3, lr_warmup_steps=1, lr_total_iter_length=10, max_grad_norm=0.5)


def _nest(flat):
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}} (the JAX tree; group labels read the path)."""
    tree = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _port_optimizer(mu_dtype, lr_mult):
    c = TrainConfig(**OPT_CFG, class_embedding_lr_mult=lr_mult)
    schedule = iter_exponential_schedule(c.learning_rate, c.lr_total_iter_length, c.lr_final_ratio,
                                         c.lr_warmup_steps)
    return OptaxAdamW(schedule, b1=c.adam_beta1, b2=c.adam_beta2, eps=c.adam_epsilon,
                      weight_decay=c.adam_weight_decay, max_grad_norm=c.max_grad_norm,
                      class_embedding_lr_mult=c.class_embedding_lr_mult, accumulate=c.gradient_accumulation_steps,
                      mu_dtype=mu_dtype)


def _train_optimizer(mu_dtype, grads, lr_mult):
    params = {n: torch.from_numpy(np.random.default_rng(1).normal(size=s).astype(np.float32))
              for n, s in SHAPES.items()}
    opt = _port_optimizer(mu_dtype, lr_mult)
    state = opt.init(params)
    for g in grads:
        opt.update({n: torch.from_numpy(v) for n, v in g.items()}, state, params)
    return params, state


def _by_name(jstate, field: str) -> dict:
    """{dotted parameter name: leaf} of an optax state's `field` trees (`mu`, ...)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        attrs = [getattr(k, "name", None) for k in path]
        if field in attrs:
            out[".".join(k.key for k in path[attrs.index(field) + 1:] if hasattr(k, "key"))] = leaf
    return out


@pytest.mark.parametrize("lr_mult", [1.0, 10.0], ids=["one-chain", "class-group"])
def test_adam_bf16_moment_matches_optax(lr_mult):
    """At a multiplier of 1 the JAX trainer builds one chain, whose clip takes
    the norm of every parameter at once; at 10 each group is clipped alone."""
    rng = np.random.default_rng(0)
    grads = [{n: (0.3 * rng.normal(size=s)).astype(np.float32) for n, s in SHAPES.items()} for _ in range(6)]
    jopt = JTrainer._build_optimizer(types.SimpleNamespace(config=JConfig(**OPT_CFG, class_embedding_lr_mult=lr_mult)))
    jparams = _nest({n: jnp.asarray(np.random.default_rng(1).normal(size=s), jnp.float32) for n, s in SHAPES.items()})
    jstate, update = jopt.init(jparams), jax.jit(jopt.update)  # jitted, as in the trainer's step
    for g in grads:
        updates, jstate = update(_nest({n: jnp.asarray(v) for n, v in g.items()}), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
    params, state = _train_optimizer(torch.bfloat16, grads, lr_mult)
    params32, _ = _train_optimizer(None, grads, lr_mult)
    assert state["count"] == 3
    jmu = _by_name(jstate, "mu")
    assert set(jmu) == set(SHAPES)
    worst = fp32_off = 0.0
    for name in SHAPES:
        assert jmu[name].dtype == jnp.bfloat16 and state["mu"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(state["mu"][name].float().numpy(), np.asarray(jmu[name].astype(jnp.float32)),
                                      err_msg=name)  # the stored moments, bit for bit
        want = np.asarray(_get(jparams, name))
        worst = max(worst, float(np.abs(params[name].numpy() - want).max()))
        fp32_off = max(fp32_off, float(np.abs(params32[name].numpy() - want).max()))
    assert worst <= 1e-6 < fp32_off


def _get(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return tree


def test_trainer_keeps_a_bf16_moment(weights):
    _, _, pt = trainers(weights, adam_mu_dtype="bfloat16", gradient_accumulation_steps=1, lr_warmup_steps=0,
                        learning_rate=1e-3)
    state = pt.init_state()
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = pt.train_step(state, make_batch(1))
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state["mu"].values())
    assert all(v.dtype == torch.float32 for v in state.opt_state["nu"].values())
    assert np.isfinite(float(metrics["grad_norm"]))
    assert max(float((state.params[n].detach() - before[n]).abs().max()) for n in before) > 1e-5


# ---------------------------------------------------------------------------
# remat_policy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    up = random_flax_params(JUNet(JUNetConfig.tiny(**UNET)), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999),
                            jnp.ones((1, 2, 32)))
    vp = random_flax_params(JVAE(JVAEConfig(**VAE)), 1, jnp.ones((1, 32, 32, 3)))
    empty = np.random.default_rng(2).normal(size=(1, 2, 32)).astype(np.float32)
    return up, vp, empty


def trainers(weights, **cfg):
    """(JAX trainer, JAX UNet params, port trainer) on the same weights, the plain VAE."""
    up, vp, empty = weights
    cfg = dict(fused_vae_kernels=False, **cfg)
    jt = JTrainer(JConfig(**cfg), JUNet(JUNetConfig.tiny(**UNET)), JVAE(JVAEConfig(**VAE)), vp, empty)
    unet = load_into(UNet2DCondition(UNetConfig.tiny(**UNET)), up)
    vae = load_into(AutoencoderKL(VAEConfig(**VAE)), vp)
    return jt, up, E2ETrainer(TrainConfig(**cfg), unet, vae, empty)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"rgb": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32), "val_mask": rng.random((B, H, W)) > 0.2,
            "target": rng.uniform(-1, 1, (B, H, W)).astype(np.float32)}


class _Count(TorchDispatchMode):
    """Counts the aten ops that run under it, by kind."""

    KINDS = {"mm": ("mm", "addmm"), "bmm": ("bmm", "baddbmm"), "conv": ("convolution",)}

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(self.KINDS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        for kind, names in self.KINDS.items():
            self.counts[kind] += name in names
        return func(*args, **(kwargs or {}))


def _forward_backward(trainer, batch):
    """(forward counts, backward counts, gradients by name)."""
    names, params = zip(*trainer.unet.named_parameters())
    with _Count() as fwd:
        loss, _ = trainer.loss(batch)
    with _Count() as bwd:
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return fwd.counts, bwd.counts, dict(zip(names, grads)), float(loss.detach())


@pytest.fixture(scope="module")
def no_checkpoint(weights):
    _, _, pt = trainers(weights, gradient_checkpointing=False)
    _, _, nothing = trainers(weights, gradient_checkpointing=True)
    return _forward_backward(pt, make_batch(3)), _forward_backward(nothing, make_batch(3))


@pytest.mark.parametrize("policy", ["dots", "dots_all"])
def test_remat_policy_matches_no_checkpoint_and_saves_its_products(weights, no_checkpoint, policy):
    (_, plain_bwd, plain_grads, plain_loss), (_, nothing_bwd, _, _) = no_checkpoint
    jt, up, pt = trainers(weights, gradient_checkpointing=True, remat_policy=policy)
    check_ported(pt.config, torch.device("cpu"))
    _, bwd, grads, loss = _forward_backward(pt, make_batch(3))
    assert loss == plain_loss
    for name, g in grads.items():
        w = plain_grads[name]
        assert float((g - w).abs().max()) <= 1e-6 * max(1.0, float(w.abs().max())), name
    # save-nothing re-runs the UNet's forward in the backward; a policy skips the products it saved
    assert nothing_bwd["mm"] > plain_bwd["mm"] and nothing_bwd["bmm"] > plain_bwd["bmm"]
    assert nothing_bwd["conv"] > plain_bwd["conv"] == 0  # the forward's convs (their backward is another op)
    assert bwd["mm"] == plain_bwd["mm"]
    assert bwd["conv"] == nothing_bwd["conv"]
    assert bwd["bmm"] == (plain_bwd["bmm"] if policy == "dots_all" else nothing_bwd["bmm"])
    # the JAX trainer under the same policy (its forward: the policy acts on the backward's recompute)
    want, _ = jax.jit(jt._loss)(up, jt._frozen(), {k: jnp.asarray(v) for k, v in make_batch(3).items()},
                                jax.random.key(0))
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)


def test_unknown_remat_policy_and_moment_dtype_raise():
    with pytest.raises(ValueError, match="remat_policy"):
        check_ported(TrainConfig(remat_policy="everything"), torch.device("cpu"))
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        check_ported(TrainConfig(adam_mu_dtype="int8"), torch.device("cpu"))


# ---------------------------------------------------------------------------
# subpixel_upsample
# ---------------------------------------------------------------------------

SUB_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)


@pytest.fixture(scope="module")
def vae_params():
    return random_flax_params(JVAE(JVAEConfig(**SUB_VAE)), 5, jnp.ones((1, 64, 64, 3)))


def test_subpixel_decoder_matches_jax_and_the_resize_path(vae_params):
    z = np.random.default_rng(5).normal(size=(1, 6, 8, 4)).astype(np.float32)
    jvae = JVAE(JVAEConfig(subpixel_upsample=True, **SUB_VAE))
    want = np.moveaxis(np.asarray(jax.jit(lambda p, z: jvae.apply({"params": p}, z, method=JVAE.decode))(
        vae_params, jnp.asarray(z))), -1, 1)
    sub = load_into(AutoencoderKL(VAEConfig(subpixel_upsample=True, **SUB_VAE)), vae_params)
    plain = load_into(AutoencoderKL(VAEConfig(**SUB_VAE)), vae_params)
    assert all(isinstance(b.upsamplers[0].conv, torch.nn.Conv2d) and b.upsamplers[0].subpixel
               for b in sub.decoder.up_blocks if b.upsamplers is not None)
    with torch.no_grad():
        got, resize = sub.decode(nchw(z)).numpy(), plain.decode(nchw(z)).numpy()
    assert got.shape == want.shape == (1, 3, 48, 64)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    np.testing.assert_allclose(got, resize, atol=3e-5, rtol=0)
    assert sub.state_dict().keys() == plain.state_dict().keys()


@pytest.mark.parametrize("out_hw", [None, (13, 11)], ids=["2x", "odd"])
def test_subpixel_upsample_keeps_the_resize_for_odd_targets(out_hw):
    torch.manual_seed(0)
    plain, sub = Upsample(16), Upsample(16, subpixel=True)
    sub.load_state_dict(plain.state_dict(), strict=True)
    x = torch.randn(2, 16, 6, 5, requires_grad=True)
    with torch.no_grad():
        want, got = plain(x, out_hw), sub(x, out_hw)
    assert got.shape == want.shape == (2, 16, *(out_hw or (12, 10)))
    if out_hw is None:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)
        gw = torch.autograd.grad(plain(x).sin().sum(), [x, plain.conv.weight])
        gs = torch.autograd.grad(sub(x).sin().sum(), [x, sub.conv.weight])
        for a, b in zip(gw, gs):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)
    else:
        assert torch.equal(got, want)


def test_trainer_frozen_vae_keeps_subpixel(weights):
    up, vp, empty = weights
    vae = load_into(AutoencoderKL(VAEConfig(subpixel_upsample=True, **VAE)), vp)
    unet = load_into(UNet2DCondition(UNetConfig.tiny(**UNET)), up)
    pt = E2ETrainer(TrainConfig(), unet, vae, empty)
    assert pt.vae.config.subpixel_upsample and pt.vae.config.fused_gn_conv
    assert pt.vae.decoder.up_blocks[0].upsamplers[0].subpixel
