"""A mesh of local torch devices and the batch helpers, port of
`diffusion_e2e_ft_tpu/parallel/mesh.py`.

The JAX mesh is a grid of devices that GSPMD runs one program over. Here a
`Mesh` is the ordered list of local devices that in-process work is split
over: the pipelines' `with_mesh` keeps one replica of their modules per mesh
device and runs each device's share of the ensemble members there
(`run_members`). A device
may appear more than once (`[cpu, cpu]`, `[cuda:0, cuda:0]`): its replicas
are one module, and its shares run one after the other.

`shard_batch` keeps the JAX rule (`take_rows`): a leaf with at least two
dimensions whose leading one divides by the axis size is split along it, any
other leaf (a 1-D vector, a batch that does not divide) is replicated to
every device. `row_block` is the one rule for a part's block of rows, which
the data-parallel ranks and their readers use too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """`device` with its index filled in (`cuda` -> `cuda:<current>`), so
    that two names of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Local devices in mesh order: the grid of `axis_sizes` flattened with
    the last axis varying fastest, as numpy reshapes the JAX mesh's device
    list. Without sizes the first axis takes every device and the others are
    of size 1, as `make_mesh` lays them out."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        if self.axis_sizes is not None:
            return dict(zip(self.axis_names, self.axis_sizes))
        return {name: (self.size if i == 0 else 1) for i, name in enumerate(self.axis_names)}

    def position(self, index: int) -> Dict[str, int]:
        """The grid coordinates of mesh position `index` (a rank), by axis."""
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(index, tuple(self.shape.values())))))


def visible_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every device of `device_type` this process sees: the cards, or the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"Unknown device type {device_type!r}; expected cuda or cpu")


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence] = None,
    device_type: str = "cuda",
) -> Mesh:
    """A mesh over `devices` (default: every visible device of `device_type`),
    cut to the first `n_devices`. Asking for more devices than there are raises."""
    devs = [canonical_device(d) for d in devices] if devices is not None else visible_devices(device_type)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"asked for {n_devices} devices, {len(devs)} are available: {devs}")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError(f"no {device_type} device is visible")
    return Mesh(tuple(devs), tuple(axis_names))


def _tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` (dataclasses, dicts, lists, tuples; None
    stays None), with the matching leaves of `rest`."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def row_block(n_rows: int, index: int, parts: int) -> slice:
    """Block `index` of `n_rows` rows cut into `parts` equal blocks, in order."""
    k = n_rows // parts
    return slice(index * k, (index + 1) * k)


def take_rows(x, index: int, parts: int):
    """Block `index` of `parts` of a batch-shaped leaf (an array or tensor of
    at least two dimensions whose leading one divides by `parts`); any other
    leaf whole, as the JAX `shard_batch` replicates it."""
    if getattr(x, "ndim", 0) >= 2 and x.shape[0] % parts == 0:
        return x[row_block(x.shape[0], index, parts)]
    return x


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> List[Any]:
    """One tree per mesh device: batch-shaped leaves split over `axis` in
    order (a device takes the block of its coordinate on it, so the devices
    of the other axes hold the same rows), the others replicated (the JAX
    `shard_batch` rule)."""
    n = mesh.shape.get(axis, mesh.size)

    def part(x, i: int, device: torch.device) -> torch.Tensor:
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return take_rows(x, mesh.position(i).get(axis, i), n).to(device)

    return [_tree_map(lambda x: part(x, i, d), batch) for i, d in enumerate(mesh.devices)]


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def run_members(replicas: Sequence[Any], mesh: Mesh, members: Any, fn: Callable[[Any, Any], Any], device) -> Any:
    """`fn(replica, shard)` on each device's `shard_batch` shard of `members`
    (a tree of member-major tensors), gathered in member order on `device`;
    `fn` returns a tensor or a tuple of them. A member count that does not
    divide over the mesh runs whole on the first device: replicated, every
    device would compute the same. One host thread runs the shards one after
    the other and moves the results once all have run."""
    if _leaves(members)[0].shape[0] % mesh.size:
        pairs = [(replicas[0], shard_batch(members, Mesh(mesh.devices[:1]))[0])]
    else:
        pairs = zip(replicas, shard_batch(members, mesh))
    outs = [fn(rep, shard) for rep, shard in pairs]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[j].to(device) for o in outs]) for j in range(len(outs[0])))
    return torch.cat([o.to(device) for o in outs])


def mesh_replicas(owner: Any, mesh: Mesh, make: Callable[[torch.device], Any]) -> List[Any]:
    """One replica a mesh position: `owner` itself on its own device, and
    `make(device)` once for each other device, shared by its repeats."""
    cache = {canonical_device(owner.device): owner}
    out = []
    for d in mesh.devices:
        d = canonical_device(d)
        if d not in cache:
            cache[d] = make(d)
        out.append(cache[d])
    return out


def frozen_copy(module: torch.nn.Module, device, config=None) -> torch.nn.Module:
    """A frozen (eval, no grad) module of its own on `device`, built from
    `config` (default: `module.config`) over `module`'s weights, in their
    dtype: their storage is shared when `module` already lies on `device`,
    copied there when not. `module` itself is not changed. This is a mesh
    device's replica and a trainer's frozen VAE."""
    with torch.device("meta"):
        own = type(module)(module.config if config is None else config)
    own.load_state_dict(module.state_dict(), assign=True)
    return own.to(device).eval().requires_grad_(False)
