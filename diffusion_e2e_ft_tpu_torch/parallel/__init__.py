"""Data parallelism, port of `diffusion_e2e_ft_tpu/parallel/`.

The JAX package shards the batch over a 1-D `Mesh(('data',))` and lets GSPMD
insert the gradient all-reduce. The port splits that in two:

- `mesh.py`: a mesh of local torch devices for in-process work (the
  pipelines' `with_mesh`: one replica of the modules per device, ensemble
  members split over them by `shard_batch`, the JAX rule);
- `sharding.py`: the process-group side of training, one process a rank
  (`init_data_parallel`: NCCL for CUDA ranks, gloo for CPU ranks, a `file://`
  or `env://` rendezvous), the rank's rows of a global batch
  (`shard_train_batch`) and the gradient all-reduce.

The FSDP axis of `make_train_mesh` is not ported (slice F2).
"""

from diffusion_e2e_ft_tpu_torch.parallel.mesh import (
    Mesh,
    canonical_device,
    frozen_copy,
    make_mesh,
    mesh_replicas,
    row_block,
    run_members,
    shard_batch,
    take_rows,
    visible_devices,
)
from diffusion_e2e_ft_tpu_torch.parallel.sharding import (
    DataParallel,
    init_data_parallel,
    is_main_process,
    make_train_mesh,
    shard_train_batch,
)

__all__ = [
    "Mesh",
    "canonical_device",
    "frozen_copy",
    "make_mesh",
    "mesh_replicas",
    "row_block",
    "run_members",
    "shard_batch",
    "take_rows",
    "visible_devices",
    "DataParallel",
    "init_data_parallel",
    "is_main_process",
    "make_train_mesh",
    "shard_train_batch",
]
