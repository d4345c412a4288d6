"""The end-to-end fine-tuning step, port of
`diffusion_e2e_ft_tpu/training/trainer.py::E2ETrainer`.

One micro-step: the frozen VAE encodes the image (no grad, x 0.18215), the UNet
runs at t = 999 on the latent concatenated with a zeros latent (or alone, for
raw SD with `noise_type=None`), the scheduler recovers x0 from the
prediction, the frozen VAE decodes x0 inside the differentiated graph, and the
task loss is taken on the decoded image: depth as the channel mean clipped to
[-1, 1] under the SSI loss, normals unit-normalized (+1e-5) and clipped under
the angular loss. A NaN loss becomes 0, and so does the loss of a batch with
no valid pixel. The optimizer has optax's semantics (`training/optim.py`),
with gradient accumulation and EMA on synced steps.

PyTorch runs eagerly, so there is nothing to jit: `train_step` updates the
UNet's parameters in place. `gradient_checkpointing` is a non-reentrant
`torch.utils.checkpoint` of the whole UNet (the JAX default, save nothing);
`vae_decode_checkpoint` does the same for the decode.

Mixed precision: the UNet keeps fp32 master weights; with
`compute_dtype=torch.bfloat16` the step runs under `torch.autocast`, so the
products (and the attention kernels) see bf16, as the JAX step computes in
bf16 with fp32 params; the frozen VAE keeps its fp32 weights too. The losses
run in fp32.

The frozen VAE: the trainer runs its own module over the caller's weights
(`frozen_copy`), with `fused_gn_conv` on when `fused_vae_kernels` is (the
default, as in the JAX trainer): on the card its resnet pairs launch the
fused GroupNorm+SiLU -> conv kernels (`kernels/gn_conv.py`), on the CPU they
run the plain composite. The caller's module is left as it was (config,
device, mode, requires_grad), so a serving pipeline that shares it keeps its
own path.

Noise: zeros (the default), gaussian, or pyramid noise drawn from a
`torch.Generator` on the trainer's device that the caller passes to each step
(`run_training` seeds one from `config.seed`). The pyramid keeps the JAX
trainer's schedule bank: 16 rows of octave scales drawn once from
`np.random.default_rng(config.seed)`, one row picked from the generator at
each step (a host sync: the row sets the octaves' shapes). The joint
GeoWizard modality is `training/geowizard.py::GeoWizardTrainer`.

Options: `adam_mu_dtype` stores Adam's first moment in that dtype with
optax's arithmetic (`training/optim.py`). `remat_policy` picks what the UNet
checkpoint keeps, as the JAX policies do: None saves nothing (the whole UNet
is recomputed); "dots" saves the outputs of the matrix products without a
batch dimension (`aten.mm`, `aten.addmm`: the linear layers,
`dots_with_no_batch_dims_saveable`); "dots_all" also the batched ones
(`aten.bmm`, `aten.baddbmm`: the plain attention's products,
`dots_saveable`). Under both the convolutions and the attention kernels are
recomputed: a JAX conv and a Pallas call are not dots.

Data parallelism (`shard` / `place_frozen`, the JAX GSPMD step's
counterparts): each rank of a `parallel.DataParallel` group holds a replica
and its rows of the global batch. The losses stay means over every valid
pixel of the global batch: a rank divides its sums by the global valid
count, and the gradients are summed over the ranks before the norm, the
clipping and the accumulation, so the step equals the one-process step on
the global batch. The no-valid-pixel guard and the NaN guard read the global
loss (a NaN on one rank zeroes every rank's). Noise and timesteps are drawn
for the global batch from the identically seeded generators and each rank
keeps its rows, so the draws do not depend on the number of ranks.

FSDP (a group with `fsdp_size > 1`, the JAX step over `Mesh(('data',
'fsdp'))`): `shard` (or `parallel.shard_state`) leaves each rank the blocks
of its fsdp index of every leaf that `param_spec` splits, in the
parameters, Adam's moments, the accumulator and the EMA; `state.sharding`
records them. A step gathers the UNet's full parameters from the master
shards over the fsdp axis before its forward and keeps them over the K
micro-steps of an accumulation window (they do not move in between); on the
synced micro-step they are released once the backward has run, since the
update moves the shards only, so between steps a rank holds its shards. The
fsdp ranks of one data group compute the same rows: each keeps its block
of every sharded gradient and sums only that, with the replicated leaves,
over the data axis, then takes the fsdp group's first rank's gradient of
the replicated leaves (so that a backward that is not bitwise
deterministic cannot let their copies drift apart), and the global norm
sums the shards' squares over the fsdp axis and counts the replicated
leaves once. Every data-parallel use above is over the
data axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition
from diffusion_e2e_ft_tpu_torch.ops import losses as L
from diffusion_e2e_ft_tpu_torch.ops import noise as noise_ops
from diffusion_e2e_ft_tpu_torch.ops import scheduler as sched_ops
from diffusion_e2e_ft_tpu_torch.parallel.mesh import frozen_copy
from diffusion_e2e_ft_tpu_torch.parallel.sharding import DataParallel, StateSharding, shard_of, shard_state
from diffusion_e2e_ft_tpu_torch.training.config import TrainConfig
from diffusion_e2e_ft_tpu_torch.training.lr import iter_exponential_schedule
from diffusion_e2e_ft_tpu_torch.training.optim import OptaxAdamW, ema_update_, global_norm, sharded_global_norm


@dataclasses.dataclass
class TrainState:
    """Host-side counters, the UNet's trainable parameters (the module's own
    tensors, by name), the optimizer state and the EMA copy. A sharded state
    (`sharding` set) holds the rank's blocks of the leaves it names and the
    module's own tensors for the others."""

    step: int  # optimizer (synced) steps
    micro_step: int  # micro-batches: step * accumulation + k
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    sharding: Optional[StateSharding] = None


def state_tensors(state: TrainState) -> list:
    """[(parameter name, tensor)] of every tensor of the state, in one order:
    the parameters, each of the optimizer's tensor dicts, the EMA."""
    out = list(state.params.items())
    for value in state.opt_state.values():
        if isinstance(value, dict):
            out += list(value.items())
    return out + list((state.ema_params or {}).items())


def gather_tensors(tree: Mapping[str, torch.Tensor], sh: Optional[StateSharding], device=None,
                   keep: bool = True) -> Optional[Dict[str, torch.Tensor]]:
    """The full tensors of a tree of parameter-named tensors sharded as `sh`
    says: its shards gathered over the fsdp axis (a collective: every rank
    of the group calls it) onto `device` (default: the shards'), bucket by
    bucket, its replicated tensors as they are; the tree itself when `sh`
    is None. None on a rank with `keep` False, which only takes part."""
    if sh is None:
        return dict(tree)
    names = [n for n in tree if n in sh.axes]
    gathered = sh.group.gather_shards([tree[n] for n in names], [sh.axes[n] for n in names], device, keep)
    if not keep:
        return None
    gathered = dict(zip(names, gathered))
    return {n: gathered.get(n, t) for n, t in tree.items()}


def gather_state(state: TrainState, device=None, keep: bool = True) -> Optional[TrainState]:
    """The full state of a sharded one, the same on every rank that keeps
    it: `gather_tensors` of its parameters, optimizer tensors and EMA. A
    state that is not sharded is returned as it is."""
    sh = state.sharding
    if sh is None:
        return state
    full = functools.partial(gather_tensors, sh=sh, device=device, keep=keep)
    opt = {k: full(v) if isinstance(v, dict) else v for k, v in state.opt_state.items()}
    params, ema = full(state.params), None if state.ema_params is None else full(state.ema_params)
    if not keep:
        return None
    return dataclasses.replace(state, params=params, opt_state=opt, ema_params=ema, sharding=None)


# what each remat policy saves of the checkpointed UNet's forward
SAVED_OPS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "dots_all": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                 torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
}
MU_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def check_ported(
    config: TrainConfig, device: torch.device, modalities: Tuple[str, ...] = ("depth", "normals")
) -> None:
    """Raise for a modality outside `modalities` (the trainer's own) and for
    an unknown noise type, remat policy or moment dtype."""
    if config.modality not in modalities:
        if config.modality == "joint":
            raise ValueError("modality='joint' is the GeoWizard trainer's: use training.geowizard.GeoWizardTrainer")
        raise ValueError(f"Unknown modality: {config.modality}")
    if config.noise_type not in (None, "zeros", "gaussian", "pyramid"):
        raise ValueError(f"Unknown noise type: {config.noise_type}")
    if config.adam_mu_dtype is not None and config.adam_mu_dtype not in MU_DTYPES:
        raise ValueError(f"Unknown adam_mu_dtype {config.adam_mu_dtype!r}; expected one of {sorted(MU_DTYPES)}")
    if config.remat_policy is not None and config.remat_policy not in SAVED_OPS:
        raise ValueError(f"Unknown remat_policy {config.remat_policy!r}; expected None, 'dots' or 'dots_all'")


def pyramid_scale_bank(seed: int, base: float, spread: float, rows: int = 16, octaves: int = 10) -> np.ndarray:
    """The JAX trainer's pyramid-noise schedule bank: `rows` x `octaves` octave
    scales r ~ U[base, base + spread), from `np.random.default_rng(seed)`."""
    return np.random.default_rng(seed).random((rows, octaves)) * spread + base


class E2ETrainer:
    """Runs the E2E fine-tuning step for one UNet against a frozen VAE."""

    MODALITIES: Tuple[str, ...] = ("depth", "normals")
    PYRAMID_BANK = (2.0, 2.0)  # octave scales r ~ U[2, 4] (base, spread)

    def __init__(
        self,
        config: TrainConfig,
        unet: UNet2DCondition,
        vae: AutoencoderKL,
        empty_text_embed: np.ndarray,  # [1, L, D] CLIP embedding of ""
        scheduler_config: Optional[sched_ops.SchedulerConfig] = None,
        latent_scale: float = 0.18215,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        self.device = next(unet.parameters()).device
        check_ported(config, self.device, self.MODALITIES)
        self.config = config
        self.compute_dtype = compute_dtype
        self.unet = unet.float().requires_grad_(True)
        fused = config.fused_vae_kernels or vae.config.fused_gn_conv
        self.vae = frozen_copy(vae, self.device, dataclasses.replace(vae.config, fused_gn_conv=fused))
        self.empty_text_embed = torch.as_tensor(np.asarray(empty_text_embed), dtype=torch.float32).to(self.device)
        self.scheduler_config = scheduler_config or sched_ops.SchedulerConfig(
            prediction_type=config.prediction_type
        )
        self.schedule = sched_ops.make_schedule(self.scheduler_config, device=self.device)
        self.latent_scale = latent_scale
        self.pyramid_scale_bank = pyramid_scale_bank(config.seed, *self.PYRAMID_BANK)
        self.dp: Optional[DataParallel] = None  # set by place_frozen / shard
        self._gathered = False  # the UNet holds full tensors of the sharded parameters
        c = config
        # the reference scales schedule lengths by the data-parallel degree
        self.lr_schedule = iter_exponential_schedule(
            c.learning_rate,
            c.lr_total_iter_length * c.num_data_parallel,
            c.lr_final_ratio,
            c.lr_warmup_steps * c.num_data_parallel,
        )
        self.optimizer = OptaxAdamW(
            self.lr_schedule, b1=c.adam_beta1, b2=c.adam_beta2, eps=c.adam_epsilon,
            weight_decay=c.adam_weight_decay, max_grad_norm=c.max_grad_norm,
            class_embedding_lr_mult=c.class_embedding_lr_mult,
            accumulate=c.gradient_accumulation_steps,
            mu_dtype=None if c.adam_mu_dtype is None else MU_DTYPES[c.adam_mu_dtype],
        )

    def init_state(self) -> TrainState:
        params = dict(self.unet.named_parameters())
        ema = {n: p.detach().clone() for n, p in params.items()} if self.config.use_ema else None
        return TrainState(0, 0, params, self.optimizer.init(params), ema)

    # ------------------------------------------------------------------
    # Data parallelism
    # ------------------------------------------------------------------

    def place_frozen(self, dp: DataParallel) -> None:
        """Join the data-parallel group `dp`. The frozen modules were built on
        the UNet's device, which must be the rank's: each rank holds its own
        replica of them, as the JAX `place_frozen` replicates them."""
        if self.device != dp.device:
            raise ValueError(f"the UNet lies on {self.device}, rank {dp.rank}'s device is {dp.device}")
        self.dp = dp

    def replicate_state(self, state: TrainState) -> TrainState:
        """Give every rank rank 0's parameters, optimizer moments and EMA; of
        a sharded state, rank 0's replicated tensors and, over the data axis,
        the shards of data index 0 at the rank's fsdp index."""
        if self.dp is not None:
            axes = {} if state.sharding is None else state.sharding.axes
            named = state_tensors(state)
            self.dp.broadcast_([t for n, t in named if n not in axes])
            if axes:
                self.dp.broadcast_shards_([t for n, t in named if n in axes])
        return state

    def shard(self, state: TrainState, batch: Mapping[str, Any], dp: DataParallel, min_size: int = 1 << 18):
        """(the replicated state, this rank's rows of the global `batch`);
        over an fsdp axis the state is the rank's shards (`shard_state` with
        `min_size`) and the UNet's sharded parameters are released."""
        self.place_frozen(dp)
        state = self.replicate_state(state)
        if dp.fsdp_size > 1:
            state = shard_state(state, dp, min_size)
            if state.sharding is not None:
                self._release_params(state.sharding)
        return state, dp.shard_batch(batch)

    def _gather_params(self, state: TrainState) -> None:
        """Point the UNet's sharded parameters at full tensors gathered from
        `state`'s master shards over the fsdp axis, unless they already are
        (within an accumulation window)."""
        sh = state.sharding
        if sh is None or self._gathered:
            return
        self._release_params(sh)  # whatever the module still holds (its tensors before `shard_state`) is stale
        params = dict(self.unet.named_parameters())
        full = gather_tensors(state.params, sh)
        for name in sh.axes:
            params[name].data = full[name]
        self._gathered = True

    def _release_params(self, sh: StateSharding) -> None:
        """Free the UNet's full tensors of the parameters `sh` shards."""
        params = dict(self.unet.named_parameters())
        for name in sh.axes:
            params[name].data = params[name].data.new_empty(0)
        self._gathered = False

    @staticmethod
    def _global_norm(tensors: Mapping[str, torch.Tensor], sh: Optional[StateSharding]) -> torch.Tensor:
        """The global norm of a gradient by parameter name; of one sharded
        as `sh` says, over the fsdp axis, each replicated leaf counted once."""
        if sh is None:
            return global_norm(list(tensors.values()))
        return sharded_global_norm([t for n, t in tensors.items() if n in sh.axes],
                                   [t for n, t in tensors.items() if n not in sh.axes], sh.group.fsdp_sum)

    def _noise(self, shape, generator: Optional[torch.Generator], timesteps: Optional[torch.Tensor] = None,
               pair: bool = False) -> torch.Tensor:
        """This rank's rows of the noise latent drawn for the global batch:
        `shape` is the rank's, `timesteps` the global batch's; `pair` takes
        the rows from both halves of a [depth; normal] task pair."""
        world = 1 if self.dp is None else self.dp.data_size
        if world == 1 or self.config.noise_type in (None, "zeros"):
            return self._make_noisy_latents(shape, generator, timesteps)
        noise = self._make_noisy_latents((shape[0] * world, *shape[1:]), generator, timesteps)
        return self._rows(noise, pair)

    def _rows(self, x: torch.Tensor, pair: bool = False) -> torch.Tensor:
        """This rank's rows of a global-batch tensor (of each half with `pair`)."""
        if self.dp is None:
            return x
        if not pair:
            return x[self.dp.rows(x.shape[0])]
        half = x.shape[0] // 2
        return torch.cat([x[:half][self.dp.rows(half)], x[half:][self.dp.rows(half)]])

    def _valid_count(self, mask: torch.Tensor) -> Optional[torch.Tensor]:
        """The global batch's valid count of `mask` (None in one process: the
        losses count their own batch)."""
        return None if self.dp is None else self.dp.all_sum(mask.sum().float())

    def _any_valid(self, mask: torch.Tensor, count: Optional[torch.Tensor]) -> torch.Tensor:
        return mask.any() if count is None else count > 0

    def _nan_guarded(self, loss: torch.Tensor) -> torch.Tensor:
        """`losses.nan_guarded` on the global loss: 0 on every rank when any
        rank's part is NaN."""
        if self.dp is None:
            return L.nan_guarded(loss)
        nan = self.dp.all_sum(torch.isnan(loss).float()) > 0
        return torch.where(nan, torch.zeros_like(loss), loss)

    # ------------------------------------------------------------------
    # Forward + loss
    # ------------------------------------------------------------------

    def _autocast(self):
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(self.device, dtype)

    def _make_noisy_latents(
        self, shape, generator: Optional[torch.Generator], timesteps: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The noise latent of `config.noise_type`, fp32 NCHW. `timesteps`
        scales the pyramid's octaves by t/1000 (GeoWizard); None is the
        Marigold / SD variant."""
        nt = self.config.noise_type
        if nt is None or nt == "zeros":
            return torch.zeros(shape, device=self.device)
        if generator is None:
            raise ValueError(f"noise_type={nt!r} draws from a torch.Generator: pass one to the step")
        if nt == "gaussian":
            return noise_ops.gaussian(generator, shape)
        # pyramid: a bank row from the generator sets the octave sizes
        row = int(torch.randint(len(self.pyramid_scale_bank), (), generator=generator, device=generator.device))
        sizes = noise_ops._octave_sizes(shape[2], shape[3], self.pyramid_scale_bank[row])
        base, octaves = noise_ops.pyramid_draws(generator, shape, sizes)
        ts = None if timesteps is None else timesteps.float() / 1000.0
        return noise_ops.pyramid_compose(base, octaves, 0.9, ts)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """Frozen VAE encode of NCHW images (no gradient into the encoder), scaled, fp32."""
        with torch.no_grad():
            return (self.vae.encode_mean(x) * self.latent_scale).float()

    def _unet(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor, *class_labels) -> torch.Tensor:
        c = self.config
        if not c.gradient_checkpointing:
            return self.unet(x, t, context, *class_labels)
        if c.remat_policy is None:
            return checkpoint(self.unet, x, t, context, *class_labels, use_reentrant=False)
        saved = functools.partial(create_selective_checkpoint_contexts, list(SAVED_OPS[c.remat_policy]))
        return checkpoint(self.unet, x, t, context, *class_labels, use_reentrant=False, context_fn=saved)

    def _decode(self, x0: torch.Tensor) -> torch.Tensor:
        """Frozen VAE decode of x0 inside the differentiated graph -> [B, H, W, 3] fp32."""
        z = x0 / self.latent_scale
        if self.config.vae_decode_checkpoint:
            decoded = checkpoint(self.vae.decode, z, use_reentrant=False)
        else:
            decoded = self.vae.decode(z)
        return decoded.float().permute(0, 2, 3, 1)

    def loss(
        self, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None, *,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The task loss of one batch: rgb [B,H,W,3] in [-1,1], val_mask [B,H,W]
        bool, target [B,H,W] (depth) or [B,H,W,3] (normals); numpy or torch.
        The noise latent is drawn from `generator` unless given as `noise`."""
        c = self.config
        rgb = self._tensor(batch["rgb"], torch.float32).permute(0, 3, 1, 2)
        mask = self._tensor(batch["val_mask"], torch.bool)
        target = self._tensor(batch["target"], torch.float32)
        b = rgb.shape[0]
        with self._autocast():
            rgb_latents = self._encode(rgb)
            t = torch.full((b,), self.scheduler_config.num_train_timesteps - 1, dtype=torch.long, device=self.device)
            noisy = self._noise(rgb_latents.shape, generator) if noise is None else noise.to(rgb_latents)
            context = self.empty_text_embed.expand(b, -1, -1)
            unet_in = torch.cat([rgb_latents, noisy], dim=1) if c.noise_type is not None else rgb_latents
            model_pred = self._unet(unet_in, t, context)
            x0 = sched_ops.pred_original_sample(self.scheduler_config, self.schedule, model_pred.float(), t, noisy)
            decoded = self._decode(x0)  # [B, H, W, 3]

        count = self._valid_count(mask)
        if c.modality == "depth":
            est = decoded.mean(dim=-1).clamp(-1.0, 1.0)
            loss = self._nan_guarded(L.ssi_loss(est, target, mask, count))
        else:
            norm = torch.linalg.vector_norm(decoded, dim=-1, keepdim=True) + 1e-5
            est = (decoded / norm).clamp(-1.0, 1.0)
            loss = self._nan_guarded(L.angular_loss(est, target, mask, count))
        # an all-invalid batch contributes zero loss (the reference skips it)
        loss = torch.where(self._any_valid(mask, count), loss, torch.zeros_like(loss))
        return loss, {"loss": loss.detach()}

    def value_and_grad(
        self, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None,
        sharding: Optional[StateSharding] = None, **explicit
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(loss, metrics, gradient of the loss by UNet parameter name);
        `explicit` goes to `loss` (the tests' fixed draws). In a data-parallel
        group the loss, the metrics and the gradients are the global batch's:
        the ranks' parts summed; with `sharding` (the state's, over an fsdp
        axis), the gradients are this rank's blocks of the ones it shards."""
        names, params = zip(*self.unet.named_parameters())
        loss, metrics = self.loss(batch, generator, **explicit)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        sh = sharding
        if sh is not None:  # the fsdp ranks computed the same rows: each keeps, and sums over 'data', its block
            grads = [g if n not in sh.axes else shard_of(g, sh.axes[n], sh.group.fsdp_index, sh.group.fsdp_size).clone()
                     for n, g in zip(names, grads)]
        if self.dp is not None:
            self.dp.all_reduce_(grads)
            keys = list(metrics)
            metrics = dict(zip(keys, self.dp.all_sum(torch.stack([metrics[k].float() for k in keys])).unbind()))
            loss = metrics["loss"]
        if sh is not None:
            # a backward that is not deterministic (atomics on the card) would let the ranks' copies of the
            # replicated leaves drift apart: every rank takes the first one's gradient of them
            sh.group.fsdp_broadcast_([g for n, g in zip(names, grads) if n not in sh.axes])
        return loss.detach(), metrics, dict(zip(names, grads))

    # ------------------------------------------------------------------
    # Train step
    # ------------------------------------------------------------------

    def train_step(
        self, state: TrainState, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """One micro-batch; gaussian and pyramid noise draw from `generator`
        (zeros noise ignores it). With gradient accumulation the parameters
        move only at every K-th call (optax.MultiSteps semantics). Metrics stay
        on the device: the losses and `grad_norm` (the raw micro-batch
        gradient's global norm, before clipping) are tensors; `lr_step` is an int.
        In a data-parallel group `batch` holds the rank's rows."""
        micro = state.micro_step + 1
        synced = micro % self.config.gradient_accumulation_steps == 0
        sh = state.sharding
        self._gather_params(state)
        _, metrics, grads = self.value_and_grad(batch, generator, sh)
        if synced and sh is not None:
            self._release_params(sh)  # the update moves the master shards only
        norm = functools.partial(self._global_norm, sh=sh)
        metrics["grad_norm"] = norm(grads)
        self.optimizer.update(grads, state.opt_state, state.params, norm=norm)
        step = state.step + int(synced)
        if synced and state.ema_params is not None:
            ema_update_(state.ema_params, state.params, self.config.ema_decay)
        metrics["lr_step"] = step
        return dataclasses.replace(state, step=step, micro_step=micro), metrics
