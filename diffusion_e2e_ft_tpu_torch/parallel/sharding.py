"""Data-parallel training across processes, port of the data axis of
`diffusion_e2e_ft_tpu/parallel/sharding.py`.

The JAX step shards the global batch over `Mesh(('data', 'fsdp'))` and GSPMD
adds the gradient psum. Here each rank is a process with its own device and
replica of the UNet: it reads its rows of the global batch
(`shard_train_batch`), computes the gradient of its part of the global loss,
and `DataParallel.all_reduce_` sums the gradients over the ranks, so every
rank takes the same optimizer step. NCCL carries CUDA ranks and gloo CPU
ranks; a caller may ask for gloo on CUDA tensors (two ranks on one card,
which NCCL refuses), never the other way round by default.

The FSDP axis (`fsdp > 1`: parameters and Adam moments sharded) is not
ported: it is slice F2.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from diffusion_e2e_ft_tpu_torch.parallel.mesh import Mesh, canonical_device, make_mesh, row_block, take_rows

BUCKET_BYTES = 256 << 20  # the collectives' flat buffers (the only size timed so far)


def make_train_mesh(
    n_devices: Optional[int] = None,
    fsdp: int = 1,
    devices: Optional[Sequence] = None,
    device_type: str = "cuda",
) -> Mesh:
    """Mesh(('data', 'fsdp')) of pure data parallelism (fsdp = 1, the parity
    configuration); the devices are the ranks' devices in rank order."""
    if fsdp != 1:
        raise NotImplementedError(f"fsdp={fsdp}: the FSDP axis is not ported yet (slice F2); use fsdp=1")
    return make_mesh(n_devices, ("data", "fsdp"), devices, device_type)


def is_main_process() -> bool:
    """Rank 0 of the process group, or a process outside any group."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


@dataclasses.dataclass
class DataParallel:
    """This process's place in a data-parallel group: its rank, the group's
    size and its device. The collectives sum over the group in place."""

    rank: int
    world: int
    device: torch.device
    backend: str

    def rows(self, n_global: int) -> slice:
        """This rank's block of a global batch of `n_global` rows."""
        if n_global % self.world:
            raise ValueError(f"a global batch of {n_global} rows does not split over {self.world} ranks")
        return row_block(n_global, self.rank, self.world)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The group's sum of a (detached) tensor, as a new tensor."""
        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    @torch.no_grad()
    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum every tensor over the group, in place (the gradient all-reduce)."""
        _bucketed(tensors, dist.all_reduce)

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite every tensor with rank `src`'s, in place."""
        _bucketed(tensors, lambda flat: dist.broadcast(flat, src))

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        dist.destroy_process_group()


def _bucketed(tensors: Sequence[torch.Tensor], collective: Callable[[torch.Tensor], Any]) -> None:
    """`collective` in place over `tensors`, through flat buffers of one dtype
    and at most `BUCKET_BYTES`, copied back into the tensors."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if not buckets or t.dtype != buckets[-1][0].dtype or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += nbytes
    for bucket in buckets:
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
) -> DataParallel:
    """Join a process group as `rank` of `world`, on `device`.

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
    init_method = f"file://{os.path.abspath(init_file)}" if init_file else "env://"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return DataParallel(rank, world, device, backend)


def shard_train_batch(batch: Mapping[str, Any], rank: int, world: int) -> dict:
    """The rank's rows of a global batch (numpy arrays or tensors): leaves of
    at least two dimensions whose leading one divides by `world` are cut into
    `world` blocks in rank order; the small per-batch vectors (GeoWizard's
    domain one-hot) are kept whole."""
    return {name: take_rows(x, rank, world) for name, x in batch.items()}
