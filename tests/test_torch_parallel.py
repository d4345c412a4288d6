"""Slice F on the CPU: the port's data parallelism (`diffusion_e2e_ft_tpu_torch
/parallel/`) against one process and against the JAX package's sharded step.

- Two gloo ranks (spawned processes, a `file://` rendezvous) train each
  scenario of `tests/_torch_dp_worker.py` on their rows of the global batch;
  a third process trains it on the whole batch. Loss and grad norm of every
  micro-step agree to 1e-5 relative, the parameters (and the EMA) after the
  steps to 1e-6 (adam_epsilon 1e-3, as `test_torch_train_step.py`), and the
  two ranks hold the same bits. The scenarios: ranks with unequal valid
  counts (where a mean of the ranks' means is off, which is checked too), a
  NaN on one rank, pyramid noise, accumulation K = 2 with EMA, and GeoWizard's
  joint step in E2E and diffusion-loss modes.
- The two ranks' first loss and grad norm equal the JAX trainer's on a
  2-device mesh (`E2ETrainer.shard`), same weights and batch, to 1e-5.
- The mesh helpers keep the JAX rules (`shard_batch`, `make_mesh`), the FSDP
  axis lays the devices out as the JAX mesh does, the mixer's ranks read their rows in the
  single-process order with the same flips, the pipelines' `with_mesh([cpu,
  cpu])` equals no mesh, and `cli.train --num_devices 2 --device cpu` trains
  and exports on the synthetic trees.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_worker as W
from _torch_port import geowizard_flax_params, random_flax_params
from test_cli_train import make_hypersim_tree, make_vkitti_tree
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, UNet2DCondition as JUNet
from diffusion_e2e_ft_tpu.models import UNetConfig as JUNetConfig, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import clip as jclip
from diffusion_e2e_ft_tpu.parallel import make_mesh as j_make_mesh, shard_batch as j_shard_batch
from diffusion_e2e_ft_tpu.training import E2ETrainer as JTrainer, TrainConfig as JConfig
from diffusion_e2e_ft_tpu_torch import parallel
from diffusion_e2e_ft_tpu_torch.data.mixer import BatchLoader
from diffusion_e2e_ft_tpu_torch.models import convert as tconvert
from diffusion_e2e_ft_tpu_torch.ops import ensemble as tens
from diffusion_e2e_ft_tpu_torch.pipelines.geowizard import GeoWizardPipeline
from diffusion_e2e_ft_tpu_torch.pipelines.marigold import MarigoldPipeline
from diffusion_e2e_ft_tpu_torch.training import checkpoints as C


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ops here are small: under the suite's parallel workers a thread
    pool per op costs far more than it gives, so this module runs on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state_dict(flax_tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tconvert.flax_params_to_state_dict(jax.tree.map(np.array, flax_tree)).items()}


@pytest.fixture(scope="module")
def flax_weights():
    up = random_flax_params(JUNet(JUNetConfig.tiny(**W.UNET)), 0, jnp.ones((1, 8, 8, 8)), jnp.asarray(999),
                            jnp.ones((1, 2, 32)))
    vp = random_flax_params(JVAE(JVAEConfig(**W.VAE)), 1, jnp.ones((1, 32, 32, 3)))
    geo = geowizard_flax_params(JUNetConfig.geowizard(**W.GEO_UNET), JVAEConfig(**W.GEO_VAE),
                                jclip.CLIPVisionConfig(**W.VISION), seed=20)
    empty = np.random.default_rng(2).normal(size=(1, 2, 32)).astype(np.float32)
    return up, vp, geo, empty


@pytest.fixture(scope="module")
def weights(flax_weights):
    up, vp, geo, empty = flax_weights
    enc = tconvert.clip_vision_params_to_state_dict(geo["image_encoder"])
    return {"unet": _state_dict(up), "vae": _state_dict(vp), "geo_unet": _state_dict(geo["unet"]),
            "geo_vae": _state_dict(geo["vae"]), "empty": empty,
            "geo_encoder": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in enc.items()}}


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    """{scenario: (rank 0's results, rank 1's, one process's)} from one spawn
    of two gloo ranks and the one-process reference beside them."""
    out = tmp_path_factory.mktemp("dp")
    path = str(out / "weights.pt")
    torch.save(weights, path)
    torch.multiprocessing.spawn(W.rank_main, args=(2, str(out / "rendezvous"), path, str(out)), nprocs=3)
    return {name: tuple(torch.load(out / f"{name}-{i}.pt", weights_only=False) for i in range(3))
            for name in W.SCENARIOS}


def _assert_params(got, want, atol=1e-6):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name", list(W.SCENARIOS))
def test_two_ranks_equal_one_process(two_ranks, weights, name):
    r0, r1, want = two_ranks[name]
    for got in (r0, r1):
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5, atol=0)
        _assert_params(got["params"], want["params"])
        if "ema" in want:
            _assert_params(got["ema"], want["ema"])
    for n in r0["params"]:  # one optimizer step on every rank: the same bits
        np.testing.assert_array_equal(r0["params"][n].numpy(), r1["params"][n].numpy(), err_msg=n)
    if name == "nan":  # the global loss is guarded on both ranks; the gradient is the one process's (NaN)
        assert r0["loss"] == r1["loss"] == want["loss"] == [0.0]
        assert np.isnan(want["grad_norm"][0]) and np.isnan(r0["grad_norm"][0])
    else:
        assert all(np.isfinite(got["grad_norm"]).all() for got in (r0, r1))
        moved = max(float((want["params"][n] - r0["params"][n]).abs().max()) for n in want["params"])
        assert moved < 1e-6 < max(float((r0["params"][n] - _initial(weights, name)[n]).abs().max())
                                  for n in r0["params"])  # it trained


def _initial(weights, name):
    return weights["geo_unet" if W.SCENARIOS[name]["family"] == "geowizard" else "unet"]


def test_mean_of_rank_means_is_not_the_global_loss(two_ranks, weights):
    """The unequal-count scenario separates the two reductions: the ranks'
    global-count loss is the one-process loss, and the mean of each rank's
    own mean is not."""
    trainer = W.build("unequal", weights)
    batch = W.make_batch("unequal", 0)
    halves = [float(trainer.loss(parallel.shard_train_batch(batch, r, 2))[1]["loss"]) for r in (0, 1)]
    whole = float(trainer.loss(batch)[1]["loss"])
    assert two_ranks["unequal"][0]["loss"][0] == pytest.approx(whole, rel=1e-5) == two_ranks["unequal"][2]["loss"][0]
    assert abs(np.mean(halves) - whole) > 100 * 1e-5 * whole


def test_two_rank_loss_equals_jax_sharded_step(two_ranks, flax_weights):
    """The JAX trainer's GSPMD step on a 2-device CPU mesh (batch sharded,
    params replicated) on the same weights and first batch."""
    up, vp, _, empty = flax_weights
    spec = W.SCENARIOS["unequal"]
    jt = JTrainer(JConfig(**W.OPT, **spec["cfg"]), JUNet(JUNetConfig.tiny(**W.UNET)), JVAE(JVAEConfig(**W.VAE)), vp,
                  empty)
    mesh = j_make_mesh(2)
    state, batch = jt.shard(jt.init_state(up), {k: jnp.asarray(v) for k, v in W.make_batch("unequal", 0).items()},
                            mesh)
    assert len(batch["rgb"].sharding.device_set) == 2
    # the step's loss and gradient (`_train_step_jit`'s first line) without its optimizer's compile
    (loss, _), grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        state.params, jt._frozen(), batch, jax.random.key(0))
    for r in (0, 1):
        got = two_ranks["unequal"][r]
        np.testing.assert_allclose(got["loss"][0], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"][0], float(optax.global_norm(grads)), rtol=1e-5)


def test_shard_batch_keeps_the_jax_rule():
    """Batch-shaped leaves split in device order, 1-D vectors and batches that
    do not divide replicate: the shapes of JAX's shards on a 2-device mesh."""
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.random((4, 6, 8, 3), np.float32), "domain": np.ones(3, np.float32),
             "odd": rng.random((3, 5), np.float32)}
    mesh = parallel.make_mesh(devices=["cpu", "cpu"])
    shards = parallel.shard_batch(batch, mesh)
    jshards = j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, j_make_mesh(2))
    for key, value in batch.items():
        want = sorted(jshards[key].addressable_shards, key=lambda s: s.device.id)  # mesh order
        assert len(shards) == len(want) == 2
        for shard, jshard in zip(shards, want):
            np.testing.assert_array_equal(shard[key].numpy(), np.asarray(jshard.data), err_msg=key)
    train = parallel.shard_train_batch(batch, 1, 2)
    np.testing.assert_array_equal(train["rgb"], batch["rgb"][2:])
    assert train["domain"] is batch["domain"] and train["odd"] is batch["odd"]


def test_make_mesh_run_members_and_the_fsdp_axis():
    mesh = parallel.make_mesh(devices=["cpu", "cpu", "cpu"], n_devices=2)
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.shape == {"data": 2} and mesh.size == 2
    assert parallel.make_mesh(device_type="cpu").devices == (torch.device("cpu"),)
    assert parallel.make_train_mesh(devices=["cpu", "cpu"]).shape == {"data": 2, "fsdp": 1}
    with pytest.raises(ValueError, match="asked for 3 devices"):
        parallel.make_mesh(3, device_type="cpu")
    assert parallel.make_train_mesh(devices=["cpu"] * 4, fsdp=2).shape == {"data": 2, "fsdp": 2}
    with pytest.raises(ValueError, match="not divisible by fsdp=3"):
        parallel.make_train_mesh(devices=["cpu", "cpu"], fsdp=3)
    calls = []
    rows = parallel.run_members(["a", "b"], mesh, torch.arange(4.0)[:, None],
                                lambda rep, x: calls.append((rep, x.tolist())) or x * 2, "cpu")
    assert calls == [("a", [[0.0], [1.0]]), ("b", [[2.0], [3.0]])] and rows.ravel().tolist() == [0, 2, 4, 6]
    calls.clear()
    parallel.run_members(["a", "b"], mesh, torch.arange(3.0)[:, None], lambda rep, x: calls.append(rep) or x, "cpu")
    assert calls == ["a"]  # 3 members do not divide over 2 devices: replicated, the first computes them


def test_collectives_bucket_by_dtype_and_size(monkeypatch):
    """The collectives run over flat buffers of one dtype and at most
    `BUCKET_BYTES` each (here 16 bytes: 4 fp32 values), and every tensor gets
    its own part of its buffer back, in place. A doubling stands in for the
    collective."""
    from diffusion_e2e_ft_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "BUCKET_BYTES", 16)
    tensors = [torch.arange(3.0), torch.arange(2.0).reshape(2, 1) + 10, torch.arange(4, dtype=torch.float64) + 20,
               torch.ones(4)]
    want = [t * 2 for t in tensors]
    sizes = []
    sharding._bucketed(tensors, lambda flat: sizes.append((flat.dtype, flat.numel())) or flat.mul_(2))
    assert sizes == [(torch.float32, 3), (torch.float32, 2), (torch.float64, 4), (torch.float32, 4)]
    for got, w in zip(tensors, want):
        assert torch.equal(got, w)
    assert parallel.row_block(6, 2, 3) == slice(4, 6)


class _FlipDataset:
    """One rng draw a sample, as the training readers draw their flips."""

    def __init__(self, n):
        self.n, self.rng, self.reads = n, np.random.default_rng(5), []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.reads.append(i)
        flip = self.rng.random() < 0.5
        return {"rgb": np.full((2, 2, 3), i, np.float32), "val_mask": np.ones((2, 2), bool),
                "metric": np.full((2, 2), float(flip), np.float32)}

    def skip(self, n):
        self.rng.random(n)


def test_rank_loaders_read_their_rows_in_the_single_process_order():
    """Two epochs of 4-row global batches: each rank's batches are its block
    of the one-process batches, flips included, and it reads no other row."""
    data = _FlipDataset(11)  # one dataset for the run, as `cli.train` builds it
    single = [b for e in range(2) for b in BatchLoader(data, 4, seed=e)]
    assert len(single) == 4 and 0 < sum(float(b["target"].sum()) for b in single) < 16 * 4  # some flips
    for rank in (0, 1):
        data = _FlipDataset(11)
        ranked = [b for e in range(2) for b in BatchLoader(data, 4, seed=e, rank=rank, world=2)]
        assert len(ranked) == 4 and len(data.reads) == 8
        for got, want in zip(ranked, single):
            for key in want:
                np.testing.assert_array_equal(got[key], want[key][2 * rank:2 * rank + 2])


@pytest.mark.parametrize("model", ["marigold", "geowizard"])
def test_with_mesh_equals_no_mesh(model, monkeypatch):
    """Four seeded gaussian members at two denoising steps: no mesh in chunks
    of 2 against [cpu, cpu] in one chunk of 4 (two on each replica), and a
    chunk of 3, which does not divide and runs whole. The repeated device
    shares the pipeline; the second position is then given a replica of its
    own (`_replica_on`, what a second card gets), so the members run on two
    distinct modules and are gathered in member order. The members reach the
    depth ensembling equal to the bit; its BFGS (the same function of the
    same members either way, held in `tests/test_torch_ensemble.py`) is
    replaced by a mean here, which keeps the test fast on a loaded CPU."""
    members = []

    def combine(preds, **kw):
        members.append(preds.clone())
        return preds.mean(0), preds.std(0)

    monkeypatch.setattr(tens, "ensemble_depths", combine)
    image = (np.random.default_rng(0).random((48, 64, 3)) * 255).astype(np.uint8)
    kw = dict(denoising_steps=2, ensemble_size=4, processing_res=0, noise="gaussian", seed=1, color_map=None)
    if model == "marigold":
        pipe, fields = MarigoldPipeline.from_random(device="cpu", scheduler_type="ddpm"), ("depth_np", "uncertainty")
    else:
        pipe, fields = GeoWizardPipeline.from_random(device="cpu"), ("depth_np", "normal_np", "uncertainty")
    want, want3 = pipe(image, batch_size=2, **kw), pipe(image, batch_size=3, **kw)
    assert pipe.with_mesh(parallel.make_mesh(devices=["cpu", "cpu"])) is pipe
    assert pipe._replicas == [pipe, pipe]
    pipe._replicas[1] = replica = pipe._replica_on(torch.device("cpu"))
    assert replica is not pipe and replica.unet is not pipe.unet and replica._replicas is None
    got, got3 = pipe(image, batch_size=4, **kw), pipe(image, batch_size=3, **kw)
    assert len(members) == 4 and members[0].shape[0] == 4
    for i in (0, 1):
        assert torch.equal(members[i + 2], members[i])
    for field in fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        np.testing.assert_array_equal(getattr(got3, field), getattr(want3, field), err_msg=field)
    assert pipe.with_mesh(None)._replicas is None


def test_cli_train_two_ranks_end_to_end(tmp_path):
    """`cli.train --num_devices 2 --device cpu`: two spawned ranks over gloo
    train one optimizer step of a 2-row global batch (one row a rank, the LR
    schedule scaled by 2), and rank 0 alone writes the arguments, the
    checkpoint and the export, whose UNet is the checkpoint's."""
    from _torch_port import write_tiny_checkpoint
    from diffusion_e2e_ft_tpu_torch.cli import train as train_cli

    ckpt = write_tiny_checkpoint(tmp_path / "ckpt", block_out_channels=(32, 64), cross_attention_levels=(False, True),
                                 num_attention_heads=(2, 2), layers_per_block=1)
    hyper_csv = make_hypersim_tree(tmp_path / "hypersim")
    make_vkitti_tree(tmp_path / "vkitti")
    out_dir = tmp_path / "run"
    train_cli.main([
        "--pretrained_model_name_or_path", ckpt, "--modality", "depth", "--output_dir", str(out_dir),
        "--hypersim_root", str(tmp_path / "hypersim"), "--hypersim_split_csv", hyper_csv,
        "--vkitti_root", str(tmp_path / "vkitti"), "--train_batch_size", "1", "--gradient_accumulation_steps", "1",
        "--max_train_steps", "1", "--checkpointing_steps", "1", "--lr_warmup_steps", "0", "--seed", "0",
        "--num_devices", "2", "--device", "cpu",
    ])
    assert [s for s, _ in C.list_checkpoints(str(out_dir))] == [1]
    saved = json.loads(open(out_dir / "arguments.txt").read().split(": ", 1)[1])
    assert saved["num_data_parallel"] == 2 and saved["train_batch_size"] == 1
    assert not [f for f in os.listdir(out_dir) if f.startswith(".rendezvous")]
    assert os.path.isfile(out_dir / "export" / "unet" / "config.json")
    pipe = MarigoldPipeline.from_hf_dir(str(out_dir / "export"), device="cpu")
    trained = torch.load(out_dir / "checkpoint-1" / "train_state.pt", weights_only=True)["params"]
    for key, value in pipe.unet.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), trained[key].detach().numpy(), err_msg=key)
