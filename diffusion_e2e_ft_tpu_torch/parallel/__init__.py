"""Data parallelism and FSDP, port of `diffusion_e2e_ft_tpu/parallel/`.

The JAX package shards the batch over `Mesh(('data', 'fsdp'))`, the large
state leaves over 'fsdp', and lets GSPMD insert the gradient all-reduce and
the parameters' all-gathers. The port splits that in two:

- `mesh.py`: a mesh of local torch devices for in-process work (the
  pipelines' `with_mesh`: one replica of the modules per device, ensemble
  members split over them by `shard_batch`, the JAX rule);
- `sharding.py`: the process-group side of training, one process a rank
  at a (data, fsdp) mesh position (`make_train_mesh`; `init_data_parallel`:
  NCCL for CUDA ranks, gloo for CPU ranks, a `file://` or `env://`
  rendezvous, a subgroup for each axis), the rank's rows of a global batch
  (`shard_train_batch`, `batch_spec`), the gradient all-reduce over the data
  axis, and the state's shards over the fsdp axis (`param_spec`,
  `state_sharding`, `shard_state`, `DataParallel.gather_shards`).
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
    StateSharding,
    batch_spec,
    init_data_parallel,
    is_main_process,
    make_train_mesh,
    param_spec,
    shard_state,
    shard_train_batch,
    state_sharding,
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
    "StateSharding",
    "batch_spec",
    "init_data_parallel",
    "is_main_process",
    "make_train_mesh",
    "param_spec",
    "shard_state",
    "shard_train_batch",
    "state_sharding",
]
