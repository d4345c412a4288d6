"""Slice F2 on the CPU: the FSDP axis of the port's (data, fsdp) training mesh
(`diffusion_e2e_ft_tpu_torch/parallel/sharding.py`, the trainers on a
sharded state) against the JAX package's rule and against one process.

- The rule: for every leaf of the full-size SD2 and GeoWizard UNet
  inventories, at fsdp 2 and 4, the port's `param_spec` on the torch shape
  (OIHW convs, [out, in] linears) shards the same leaves as the JAX
  `param_spec` on the Flax shape (HWIO, [in, out]), with the same elements a
  rank. Shapes only: no model.
- The step: one spawn of 4 gloo ranks as mesh (data 2, fsdp 2), with
  `min_size = 2^12` as the JAX `dryrun_multichip` uses so that the tiny
  models shard, and a fifth process training the same scenarios of
  `tests/_torch_dp_worker.py` on the whole global batch: SD2 with pyramid
  noise, accumulation K = 2 and EMA; GeoWizard with a class-embedding LR
  multiplier (its own clipping group) and the bf16 first moment. Loss and
  grad norm of every micro-step agree to 1e-5 relative, the parameters and
  the EMA to 1e-6 (the bounds of `tests/test_torch_parallel.py`), the four
  ranks' gathered parameters are equal to the bit, each rank stores exactly
  the rule's share of the state, and the UNet holds no full sharded tensor
  between steps.
- Against JAX: each scenario's first micro-step loss and grad norm on every
  rank equal the JAX trainer's on the same weights and global batch, its
  state sharded over `make_train_mesh(4, fsdp=2)` by the JAX `shard_state`
  at the same `min_size` and the step run by GSPMD, to 1e-5 (the noise
  latent is the port's draw, fed to the JAX loss: the streams differ, and
  the draws are held in `tests/test_torch_noise.py`).
- Checkpoints: the file saved from the sharded group equals, tensor by
  tensor, the full state gathered in the same run; it restores into a
  sharded group (the same shards, to the bit) and into one process.
- The mesh and batch helpers keep the JAX layout, and the sharded global
  norm counts a replicated leaf once.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_worker as W
from _torch_port import dp_scenario_flax_weights, dp_scenario_weights
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.models import convert as jconvert
from diffusion_e2e_ft_tpu.parallel import make_train_mesh as j_make_train_mesh, param_spec as j_param_spec
from diffusion_e2e_ft_tpu.parallel import shard_train_batch as j_shard_train_batch
from diffusion_e2e_ft_tpu.parallel.sharding import batch_spec as j_batch_spec, shard_state as j_shard_state
from diffusion_e2e_ft_tpu.training import E2ETrainer as JTrainer, GeoWizardTrainer as JGeoTrainer
from diffusion_e2e_ft_tpu.training import TrainConfig as JConfig
from diffusion_e2e_ft_tpu_torch import parallel
from diffusion_e2e_ft_tpu_torch.tools.hf_key_inventory import load_fixture
from diffusion_e2e_ft_tpu_torch.training import checkpoints as C
from diffusion_e2e_ft_tpu_torch.training.optim import global_norm, sharded_global_norm

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "hf_keys")
WORLD = W.FSDP_DATA * W.FSDP_SIZE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops: one thread, as `tests/test_torch_parallel.py` runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flax_shape(key, shape):
    """The Flax layout of an HF leaf, from the JAX converter, without data."""
    path = jconvert.torch_key_to_flax_path(key, len(shape))
    return jconvert._to_flax_value(path, np.broadcast_to(np.float32(0), shape)).shape


def _per_rank(shape, axis, fsdp):
    n = int(np.prod(shape))
    return n if axis is None else n // fsdp


# (inventory, sharded leaves, their parameters, all parameters) at min_size 2^18, fsdp 2 or 4
RECKONING = {"sd2_unet_8ch": (686, 237, 860_733_440, 865_922_244),
             "geowizard_unet": (690, 228, 853_524_480, 861_186_244)}


@pytest.mark.parametrize("fsdp", [2, 4])
@pytest.mark.parametrize("name", list(RECKONING))
def test_param_spec_shards_the_jax_leaves(name, fsdp):
    inventory = load_fixture(FIXTURES, name)
    sharded, elements, per_rank = 0, 0, 0
    for key, shape in inventory.items():
        axis = parallel.param_spec(shape, fsdp)
        spec = tuple(j_param_spec(_flax_shape(key, shape), fsdp))
        jax_axis = spec.index("fsdp") if "fsdp" in spec else None
        assert (axis is None) == (jax_axis is None), key
        assert _per_rank(shape, axis, fsdp) == _per_rank(_flax_shape(key, shape), jax_axis, fsdp), key
        if axis is not None:
            assert shape[axis] % fsdp == 0
            sharded, elements = sharded + 1, elements + int(np.prod(shape))
        per_rank += _per_rank(shape, axis, fsdp)
    leaves, want_sharded, want_elements, total = RECKONING[name]
    assert (len(inventory), sharded, elements) == (leaves, want_sharded, want_elements)
    assert per_rank == total - want_elements + want_elements // fsdp
    assert parallel.param_spec((64, 64), fsdp, min_size=1 << 13) is None  # 4096 elements: replicated
    assert parallel.param_spec((3, 5, 1 << 16), 2) == 2  # the largest divisible axis
    assert parallel.param_spec((7, 1 << 16 | 1), 2) is None  # no axis divides


@pytest.fixture(scope="module")
def flax_weights():
    return dp_scenario_flax_weights()


@pytest.fixture(scope="module")
def weights(flax_weights):
    return dp_scenario_weights(flax_weights)


@pytest.fixture(scope="module")
def four_ranks(weights, tmp_path_factory):
    """{scenario: [rank 0..3's results, one process's]} from one spawn of four
    gloo ranks at (data 2, fsdp 2) and the one-process reference beside them."""
    out = tmp_path_factory.mktemp("fsdp")
    path = str(out / "weights.pt")
    torch.save(weights, path)
    names = list(W.FSDP_SCENARIOS)
    torch.multiprocessing.spawn(W.rank_main, args=(WORLD, str(out / "rendezvous"), path, str(out), names, W.FSDP_SIZE),
                                nprocs=WORLD + 1)
    return {name: [torch.load(out / f"{name}-{i}.pt", weights_only=False) for i in range(WORLD + 1)] for name in names}


def _assert_close(got, want, atol=1e-6):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].float().numpy(), want[name].float().numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("name", list(W.FSDP_SCENARIOS))
def test_fsdp_ranks_equal_one_process(four_ranks, weights, name):
    *ranks, want = four_ranks[name]
    for got in ranks:
        assert got["step"] == want["step"] > 0
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5, atol=0)
        _assert_close(got["params"], want["params"])
        if "ema" in want:
            _assert_close(got["ema"], want["ema"])
    for got in ranks[1:]:  # the gathered parameters: the same bits on every rank
        for n, p in ranks[0]["params"].items():
            assert torch.equal(got["params"][n], p), n
    start = weights["geo_unet" if W.FSDP_SCENARIOS[name]["family"] == "geowizard" else "unet"]
    assert max(float((ranks[0]["params"][n] - start[n]).abs().max()) for n in start) > 1e-6  # it trained


def _port_noise(name, weights):
    """The noise latent (NCHW, global batch) the port's first micro-step
    draws from the scenario's seeded generator."""
    trainer = W.build(name, weights)
    drawn = []
    make = trainer._make_noisy_latents
    trainer._make_noisy_latents = lambda *a, **k: drawn.append(make(*a, **k)) or drawn[-1]
    trainer.loss(W.make_batch(name, 0), torch.Generator().manual_seed(trainer.config.seed))
    assert len(drawn) == 1 and float(drawn[0].abs().max()) > 0
    return drawn[0]


@pytest.mark.parametrize("name", list(W.FSDP_SCENARIOS))
def test_fsdp_ranks_equal_jax_sharded_step(four_ranks, flax_weights, weights, name):
    """The JAX trainer's loss and gradient on the (data 2, fsdp 2) mesh:
    the batch over 'data', the state by the JAX `shard_state` (GSPMD
    gathers the parameters and reduces the gradients)."""
    up, vp, geo, empty = flax_weights
    spec = W.FSDP_SCENARIOS[name]
    config = JConfig(**{**W.OPT, **spec["cfg"]})
    if spec["family"] == "geowizard":
        jt = JGeoTrainer(config, JUNet(JUNetConfig.geowizard(**W.GEO_UNET)), JVAE(JVAEConfig(**W.GEO_VAE)),
                         geo["vae"], jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig(**W.VISION)),
                         geo["image_encoder"])
        unet_params = geo["unet"]
    else:
        jt = JTrainer(config, JUNet(JUNetConfig.tiny(**W.UNET)), JVAE(JVAEConfig(**W.VAE)), vp, empty)
        unet_params = up
    noise = jnp.asarray(np.moveaxis(_port_noise(name, weights).numpy(), 1, -1))

    def fixed_noise(key, shape, timesteps=None):
        assert tuple(shape) == noise.shape
        return noise

    jt._make_noisy_latents = fixed_noise
    mesh = j_make_train_mesh(WORLD, fsdp=W.FSDP_SIZE)
    state, batch = jt.shard(jt.init_state(unet_params), {k: jnp.asarray(v) for k, v in W.make_batch(name, 0).items()},
                            mesh)
    state = j_shard_state(state, mesh, min_size=W.FSDP_MIN_SIZE)
    sharded = [x for x in jax.tree.leaves(state.params) if "fsdp" in tuple(x.sharding.spec)]
    assert sharded and len(batch["rgb"].sharding.device_set) == WORLD
    (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        state.params, jt._frozen(), batch, jax.random.key(0))
    *ranks, _ = four_ranks[name]
    for got in ranks:
        np.testing.assert_allclose(got["loss"][0], float(loss), rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norm"][0], float(optax.global_norm(grads)), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", list(W.FSDP_SCENARIOS))
def test_each_rank_stores_its_share(four_ranks, name):
    """Every stored tensor (parameters, Adam's moments, the accumulator, the
    EMA) has the rule's elements, and the UNet keeps only the replicated
    leaves' full tensors between steps."""
    *ranks, want = four_ranks[name]
    shapes = {n: tuple(p.shape) for n, p in want["params"].items()}
    axes = {n: parallel.param_spec(s, W.FSDP_SIZE, W.FSDP_MIN_SIZE) for n, s in shapes.items()}
    assert 0 < sum(a is not None for a in axes.values()) < len(axes)
    for got in ranks:
        assert got["axes"] == {n: a for n, a in axes.items() if a is not None}
        kinds = {key.split("/", 1)[0] for key in got["stored"]}
        accumulates = W.FSDP_SCENARIOS[name]["cfg"]["gradient_accumulation_steps"] > 1
        assert kinds == {"params", "mu", "nu"} | ({"acc"} if accumulates else set()) | ({"ema"} if "ema" in want else set())
        for key, n in got["stored"].items():
            param = key.split("/", 1)[1]
            assert n == _per_rank(shapes[param], axes[param], W.FSDP_SIZE), key
        assert got["module"] == {n: (0 if axes[n] is not None else int(np.prod(s))) for n, s in shapes.items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    mine = sum(_per_rank(s, axes[n], W.FSDP_SIZE) for n, s in shapes.items())
    assert mine < total


@pytest.mark.parametrize("name", list(W.FSDP_SCENARIOS))
def test_checkpoint_from_sharded_group(four_ranks, weights, name):
    """The group's file is the full state gathered in the same run, tensor by
    tensor and in the one-process layout; it restored into a sharded group
    (every rank's shards equal to the bit) and restores into one process."""
    *ranks, _ = four_ranks[name]
    gathered = ranks[0]["gathered"]
    saved = torch.load(os.path.join(ranks[0]["checkpoint"], C.STATE_FILE), weights_only=True)
    assert set(saved) == {"step", "micro_step", "params", "opt_state", "ema_params"}
    for key in ("params", "ema_params"):
        assert (saved[key] is None) == (gathered[key] is None)
        for n, t in (gathered[key] or {}).items():
            assert saved[key][n].shape == t.shape and torch.equal(saved[key][n], t), (key, n)
    for key, value in gathered["opt_state"].items():
        if isinstance(value, dict):
            for n, t in value.items():
                assert saved["opt_state"][key][n].dtype == t.dtype and torch.equal(saved["opt_state"][key][n], t), n
        else:
            assert saved["opt_state"][key] == value
    assert all(r["restored_equal"] for r in ranks)
    trainer = W.build(name, weights)
    state = C.restore_checkpoint(ranks[0]["checkpoint"], trainer.init_state())
    assert state.step == saved["step"] and state.sharding is None
    for n, p in trainer.unet.named_parameters():
        assert torch.equal(p.detach(), gathered["params"][n]), n


def test_train_mesh_and_batch_keep_the_jax_layout():
    """(data 2, fsdp 2): rank r at (r // 2, r % 2), the batch's rows over
    'data' only, so the fsdp ranks of one data group hold the same rows, as
    the JAX shards on a (2, 2) device grid."""
    mesh = parallel.make_train_mesh(devices=["cpu"] * 4, fsdp=2)
    assert mesh.shape == {"data": 2, "fsdp": 2} and mesh.size == 4
    assert [mesh.position(r) for r in range(4)] == [{"data": r // 2, "fsdp": r % 2} for r in range(4)]
    assert parallel.make_train_mesh(devices=["cpu"] * 2).shape == {"data": 2, "fsdp": 1}
    with pytest.raises(ValueError, match="not divisible by fsdp=3"):
        parallel.make_train_mesh(devices=["cpu"] * 4, fsdp=3)
    assert parallel.batch_spec(4) == tuple(j_batch_spec(4))
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.random((4, 6, 8, 3), np.float32), "domain": np.ones(3, np.float32)}
    shards = parallel.shard_batch(batch, mesh)
    jmesh = j_make_train_mesh(4, fsdp=2)
    jshards = j_shard_train_batch({k: jnp.asarray(v) for k, v in batch.items()}, jmesh)
    order = list(np.asarray(jmesh.devices).reshape(-1))
    for key in batch:
        by_device = {s.device: np.asarray(s.data) for s in jshards[key].addressable_shards}
        for i, device in enumerate(order):
            np.testing.assert_array_equal(shards[i][key].numpy(), by_device[device], err_msg=f"{key} {i}")


class _Group:
    """An fsdp group's position without a process group: `fsdp_sum` stands
    for the sum over `fsdp_size` ranks whose shards have equal squares."""

    def __init__(self, index, size):
        self.fsdp_index, self.fsdp_size = index, size

    def fsdp_sum(self, t):
        return t * self.fsdp_size


def test_shard_state_and_the_sharded_norm():
    """`shard_state` keeps the replicated leaves as they are (the module's
    own tensors) and the rank's block of the others, and records the axes;
    the sharded norm counts a replicated leaf once, not once a rank."""
    from diffusion_e2e_ft_tpu_torch.training import TrainState

    big, small = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4), torch.ones(3)
    state = TrainState(1, 2, {"big": big, "small": small},
                       {"count": 1, "mu": {"big": big.bfloat16(), "small": small.bfloat16()}, "acc": None})
    axes = parallel.state_sharding(state, 2, min_size=16)
    assert axes.params == {"big": 0, "small": None} and axes.opt_state["count"] is None and axes.step is None
    got = parallel.shard_state(state, _Group(1, 2), min_size=16)
    assert got.params["small"] is small and got.opt_state["count"] == 1 and got.opt_state["acc"] is None
    assert torch.equal(got.params["big"], big[4:]) and got.params["big"].is_contiguous()
    assert got.opt_state["mu"]["big"].dtype == torch.bfloat16 and torch.equal(got.opt_state["mu"]["big"].float(), big[4:])
    assert got.sharding.axes == {"big": 0} and got.sharding.group.fsdp_index == 1
    assert parallel.shard_state(state, _Group(0, 2), min_size=64).sharding is None  # nothing large enough
    # two ranks with shards of equal squares: |g|^2 = 2 |shard|^2 + |replicated|^2
    shard, rep = torch.full((4,), 2.0), torch.full((3,), 1.0)
    want = global_norm([shard, shard, rep])
    assert torch.allclose(sharded_global_norm([shard], [rep], _Group(0, 2).fsdp_sum), want, rtol=1e-7, atol=0)
    assert not torch.allclose(sharded_global_norm([shard, rep], [], _Group(0, 2).fsdp_sum), want)
