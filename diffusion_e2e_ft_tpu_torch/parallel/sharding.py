"""Data-parallel and FSDP training across processes, port of
`diffusion_e2e_ft_tpu/parallel/sharding.py`.

The JAX step runs over `Mesh(('data', 'fsdp'))`: the batch is sharded over
'data' (`batch_spec`), every state leaf of at least `min_size` elements is
split over 'fsdp' along its largest divisible axis (`param_spec`), and GSPMD
adds the gradient psum and the parameters' all-gathers. Here each rank is a
process with its own device. Its place in the mesh is `rank = data_index *
fsdp + fsdp_index` (the last axis fastest, as the JAX mesh reshapes its
device list), and `init_data_parallel` opens one `torch.distributed`
subgroup for its data axis and one for its fsdp axis. A rank reads its
data group's rows of the global batch (`shard_train_batch`; the fsdp ranks
of one data group read the same rows), computes the gradient of its part of
the global loss, and `DataParallel.all_reduce_` sums it over the data axis.
With `fsdp > 1`, `shard_state` keeps the rank's block of each sharded leaf
(parameters, Adam moments, accumulator, EMA) and `gather_shards` rebuilds
the full tensors over the fsdp axis. NCCL carries CUDA ranks and gloo CPU
ranks; a caller may ask for gloo on CUDA tensors (two ranks on one card,
which NCCL refuses), never the other way round by default.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffusion_e2e_ft_tpu_torch.parallel.mesh import Mesh, _tree_map, canonical_device, make_mesh, row_block, take_rows

BUCKET_BYTES = 256 << 20  # the collectives' flat buffers (the only size timed so far)


def make_train_mesh(
    n_devices: Optional[int] = None,
    fsdp: int = 1,
    devices: Optional[Sequence] = None,
    device_type: str = "cuda",
) -> Mesh:
    """Mesh(('data', 'fsdp')): n_devices / fsdp data-parallel groups of fsdp
    shards, the devices in rank order (an fsdp group is `fsdp` consecutive
    ranks). fsdp = 1 is pure data parallelism (the parity configuration)."""
    devs = make_mesh(n_devices, ("data", "fsdp"), devices, device_type).devices
    n = len(devs)
    if n % fsdp != 0:
        raise ValueError(f"{n} devices not divisible by fsdp={fsdp}")
    return Mesh(devs, ("data", "fsdp"), (n // fsdp, fsdp))


def param_spec(shape: Sequence[int], fsdp_size: int, min_size: int = 1 << 18) -> Optional[int]:
    """The axis a leaf of `shape` is split along over 'fsdp' (its largest
    fsdp-divisible axis), or None for a replicated leaf (fsdp of 1, fewer
    than `min_size` elements, no axis that divides)."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return None
    # prefer the largest axis; fall back to any divisible axis
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for ax in order:
        if shape[ax] % fsdp_size == 0 and shape[ax] >= fsdp_size:
            return ax
    return None


def batch_spec(ndim: int) -> tuple:
    """The mesh axis of each dimension of a batch leaf: rows over 'data'."""
    return ("data", *([None] * (ndim - 1)))


def state_sharding(state: Any, fsdp_size: int, min_size: int = 1 << 18) -> Any:
    """The tree of `state` (dataclasses, dicts, lists) with each tensor leaf
    replaced by its fsdp axis (`param_spec`; None: replicated) and every
    other leaf by None."""
    return _tree_map(lambda x: param_spec(tuple(x.shape), fsdp_size, min_size) if torch.is_tensor(x) else None, state)


def shard_of(x: torch.Tensor, axis: int, index: int, parts: int) -> torch.Tensor:
    """Block `index` of `parts` of `x` along `axis` (a view)."""
    k = x.shape[axis] // parts
    return x.detach().narrow(axis, index * k, k)


@dataclasses.dataclass(frozen=True)
class StateSharding:
    """Where a sharded TrainState lies: its group, and the fsdp axis of each
    sharded parameter by name. The parameter's Adam moments, accumulator and
    EMA are split along the same axis (the same shape, the same rule); a
    name without an axis is replicated."""

    group: "DataParallel"
    axes: Mapping[str, int]


def shard_state(state: Any, group: "DataParallel", min_size: int = 1 << 18) -> Any:
    """The rank's shards of a replicated state (every rank holding rank 0's,
    `replicate_state`): each leaf that `state_sharding` splits becomes a
    contiguous copy of the rank's block along its axis, every other leaf is
    kept as it is (the same tensor). A state with a `sharding` field (the
    trainers' `TrainState`) records where its parameters went there."""
    axes = state_sharding(state, group.fsdp_size, min_size)
    out = _tree_map(lambda x, a: x if a is None else shard_of(x, a, group.fsdp_index, group.fsdp_size).clone(),
                    state, axes)
    if hasattr(out, "sharding") and hasattr(out, "params"):
        sharded = {name: a for name, a in axes.params.items() if a is not None}
        out = dataclasses.replace(out, sharding=StateSharding(group, sharded) if sharded else None)
    return out


def is_main_process() -> bool:
    """Rank 0 of the process group, or a process outside any group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


@dataclasses.dataclass
class DataParallel:
    """This process's place in a (data, fsdp) group: its rank among the
    group's `world` ranks, its device, and the subgroups of its two mesh
    axes (None: the data axis is every rank, and there is no fsdp axis).
    The data-axis collectives sum over the ranks that hold other rows."""

    rank: int
    world: int
    device: torch.device
    backend: str
    fsdp_size: int = 1
    data_group: Any = None
    fsdp_group: Any = None

    @property
    def data_size(self) -> int:
        return self.world // self.fsdp_size

    @property
    def data_index(self) -> int:
        return self.rank // self.fsdp_size

    @property
    def fsdp_index(self) -> int:
        return self.rank % self.fsdp_size

    @property
    def _one_data_rank(self) -> bool:
        """An fsdp axis beside a data axis of one rank: nothing to sum over 'data'."""
        return self.fsdp_size > 1 and self.data_size == 1

    def rows(self, n_global: int) -> slice:
        """This rank's block of a global batch of `n_global` rows: its data index's."""
        if n_global % self.data_size:
            raise ValueError(f"a global batch of {n_global} rows does not split over {self.data_size} data ranks")
        return row_block(n_global, self.data_index, self.data_size)

    def shard_batch(self, batch: Mapping[str, Any]) -> dict:
        """This rank's rows of a global batch (`shard_train_batch` over the data axis)."""
        return shard_train_batch(batch, self.data_index, self.data_size)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The data axis's sum of a (detached) tensor, as a new tensor."""
        t = t.detach().clone()
        if not self._one_data_rank:
            dist.all_reduce(t, group=self.data_group)
        return t

    def fsdp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The fsdp axis's sum of a (detached) tensor, as a new tensor."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.fsdp_group)
        return t

    @torch.no_grad()
    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum every tensor over the data axis, in place (the gradient all-reduce)."""
        if not self._one_data_rank:
            _bucketed(tensors, lambda flat: dist.all_reduce(flat, group=self.data_group))

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite every tensor with rank `src`'s, in place."""
        _bucketed(tensors, lambda flat: dist.broadcast(flat, src))

    @torch.no_grad()
    def broadcast_shards_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite every shard with the one of data index 0 at this rank's
        fsdp index (rank `fsdp_index`), in place, over the data axis."""
        if not self._one_data_rank:
            _bucketed(tensors, lambda flat: dist.broadcast(flat, self.fsdp_index, group=self.data_group))

    @torch.no_grad()
    def fsdp_broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite every tensor with the fsdp group's first rank's, in place."""
        _bucketed(tensors, lambda flat: dist.broadcast(flat, self.data_index * self.fsdp_size, group=self.fsdp_group))

    @torch.no_grad()
    def gather_shards(self, shards: Sequence[torch.Tensor], axes: Sequence[int], device=None,
                      keep: bool = True) -> List[Optional[torch.Tensor]]:
        """The full tensors of the fsdp axis's shards: `shards[i]` is this
        rank's block of a tensor split along `axes[i]`. One all-gather over
        the fsdp group a flat bucket of shards; each bucket's full tensors
        move to `device` (default: the shards') before the next bucket is
        gathered, so a gather to the host holds one bucket on the card. A
        rank with `keep` False takes part in the collectives and keeps
        nothing (None for every tensor)."""
        full: List[Optional[torch.Tensor]] = [None] * len(shards)
        for bucket in _buckets(shards):
            flat = torch.cat([shards[i].reshape(-1) for i in bucket])
            parts = flat.new_empty(self.fsdp_size * flat.numel())
            dist.all_gather_into_tensor(parts, flat, group=self.fsdp_group)
            if not keep:
                continue
            parts = parts.view(self.fsdp_size, -1)
            offset = 0
            for i in bucket:
                n, shape = shards[i].numel(), shards[i].shape
                t = torch.cat([parts[r, offset:offset + n].view(shape) for r in range(self.fsdp_size)], axes[i])
                full[i] = t if device is None else t.to(device)
                offset += n
        return full

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        dist.destroy_process_group()


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[int]]:
    """The indices of `tensors` cut, in order, into runs of one dtype and at
    most `BUCKET_BYTES` (a larger tensor is a run of its own)."""
    bucket: List[int] = []
    size = 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != tensors[bucket[0]].dtype or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(i)
        size += nbytes
    if bucket:
        yield bucket


def _bucketed(tensors: Sequence[torch.Tensor], collective: Callable[[torch.Tensor], Any]) -> None:
    """`collective` in place over `tensors`, through flat buffers of one dtype
    and at most `BUCKET_BYTES`, copied back into the tensors."""
    for indices in _buckets(tensors):
        bucket = [tensors[i] for i in indices]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def init_data_parallel(
    rank: int,
    world: int,
    device,
    init_file: Optional[str] = None,
    backend: Optional[str] = None,
    fsdp: int = 1,
) -> DataParallel:
    """Join a process group as `rank` of `world`, on `device`, at mesh
    position (rank // fsdp, rank % fsdp) of (world // fsdp, fsdp).

    The backend is NCCL for a CUDA device and gloo for the CPU unless
    `backend` names one. The rendezvous is a `file://` store at `init_file`
    (a path no earlier group used; every rank passes the same one), or, with
    no file, torchrun's `env://` (MASTER_ADDR, MASTER_PORT)."""
    device = canonical_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only: a CPU rank takes gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world % fsdp:
        raise ValueError(f"{world} ranks not divisible by fsdp={fsdp}")
    init_method = f"file://{os.path.abspath(init_file)}" if init_file else "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    data_group = fsdp_group = None
    if fsdp > 1:  # every rank creates every subgroup, in one order, or the rendezvous waits for ever
        data = world // fsdp
        for j in range(fsdp):
            group = dist.new_group([i * fsdp + j for i in range(data)])
            data_group = group if rank % fsdp == j else data_group
        for i in range(data):
            group = dist.new_group([i * fsdp + j for j in range(fsdp)])
            fsdp_group = group if rank // fsdp == i else fsdp_group
    return DataParallel(rank, world, device, backend, fsdp, data_group, fsdp_group)


def shard_train_batch(batch: Mapping[str, Any], rank: int, world: int) -> dict:
    """Block `rank` of `world` of a global batch (numpy arrays or tensors):
    leaves of at least two dimensions whose leading one divides by `world`
    are cut into `world` blocks in order (`batch_spec`); the small per-batch
    vectors (GeoWizard's domain one-hot) are kept whole. Over a (data, fsdp)
    group, `rank` and `world` are the data index and size."""
    return {name: take_rows(x, rank, world) for name, x in batch.items()}
