"""CUDA graphs of a module's forward, one a key, captured at a key's second
call and replayed at every later one.

`Graphed` is the base of the modules served at a few fixed shapes (the UNet,
the CLIP image tower): their `forward` runs its body through
`self._graphs(self, body, *inputs)`. The cache engages only where a replay is the
eager call: the inputs on a CUDA device, inference mode on (the pipelines'
`infer`), no parameter requiring grad, no forward hook on a submodule (a
replay runs no Python; the module's own hooks run around it), and the stream not capturing already.
Anywhere else (the CPU, the trainers, `tools/activation_diff.py`'s hooks, a
caller's own capture) the body runs eagerly, as if there were no cache.

A key is what the call can observe: each tensor input's device, dtype,
shape and strides (None for one left out) and the kernels' options read at
each call (`kernels/_build.py::options`). A key's first call runs eagerly, so cuDNN's
heuristics, the kernel library's build and each entry point's one-time
set-up happen outside any capture. Its second warms up on the device's
capture stream (that eager run is the call's answer), then captures the body
over static input buffers (in the inputs' memory layout, so a
channels_last input keeps the kernels it takes eagerly; an expanded one is
made whole) into a graph with a private memory pool. Each
later call copies its inputs into those buffers, replays, and returns a clone
of the static output, so a later replay cannot overwrite a result still in
use. The kernels' launch counts are recorded at the capture and added at each
replay (`_build.recording`), so a call counts the kernels it ran.

The graph holds the parameters by address: `Graphed` drops its cache where
they may move (`_apply`: `.to`, `.cuda`, `.half`, ...; `load_state_dict`).
Weights changed in place are read by the next replay. `counts` holds the
process's `graph_replays` (calls served by a replay) and `graph_misses`
(calls that met the conditions and still ran eagerly: a first sight, a
capture, a key seen again after its eviction); the `request` span of
`utils/trace.py` records both.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch
from torch import nn

from diffusion_e2e_ft_tpu_torch.kernels import _build

# keys a module holds, the least recently used evicted first: a captured key pins a private pool as large as the
# forward's peak at its shape (the bf16 SD2 UNet at 768x768: hundreds of MB), so a server that sees many image
# sizes would otherwise keep one such pool for every size it has seen
LIMIT = 4

counts = {"graph_replays": 0, "graph_misses": 0}
_STREAMS: dict = {}  # device -> the stream that captures there


def _global_hooks() -> bool:
    g = nn.modules.module
    return bool(g._global_forward_hooks or g._global_forward_pre_hooks)


class Graph:
    """A captured call: static inputs, the graph, its static output, and the
    kernel launches its capture recorded, (counts, name) a kernel."""

    __slots__ = ("inputs", "graph", "output", "launches")

    def __init__(self, inputs, graph, output, launches):
        self.inputs, self.graph, self.output, self.launches = inputs, graph, output, launches

    def replay(self, inputs) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(x)
        self.graph.replay()
        for counter, name in self.launches:
            counter[name] += 1
        return self.output.clone()


def capture(fn: Callable, inputs: tuple):
    """Warm `fn` up on the inputs' device's capture stream, then capture it
    over static copies of `inputs`. Returns (the warm-up's output, Graph)."""
    device = next(x.device for x in inputs if x is not None)
    with torch.cuda.device(device):
        caller = torch.cuda.current_stream()
        stream = _STREAMS.setdefault(device, torch.cuda.Stream())
        static = tuple(None if x is None else torch.empty_like(x) for x in inputs)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = fn(*inputs)
            graph = torch.cuda.CUDAGraph()
            with _build.recording() as recorded:
                graph.capture_begin(pool=torch.cuda.graph_pool_handle())
                try:
                    output = fn(*static)
                finally:
                    graph.capture_end()
        caller.wait_stream(stream)
        out.record_stream(caller)  # allocated on the capture stream, used on the caller's
    return out, Graph(static, graph, output, tuple(recorded))


class GraphCache:
    """A module's graphs by key, at most `limit`, least recently used evicted
    first; `capture` makes a key's graph (a stand-in in the CPU tests)."""

    def __init__(self, limit: int = LIMIT, capture: Callable = capture):
        self.limit, self._capture = limit, capture
        self._entries: collections.OrderedDict = collections.OrderedDict()  # key -> Graph, or None: seen once
        self._owned: Optional[tuple] = None  # the owner's (parameters, modules), listed at a first CUDA call

    def __reduce__(self):  # a copy (deepcopy, pickle) starts empty: its parameters lie elsewhere
        return GraphCache, (self.limit, self._capture)

    def clear(self) -> None:
        self._entries.clear()
        self._owned = None

    def keys(self) -> list:
        return list(self._entries)

    def captured(self) -> int:
        return sum(g is not None for g in self._entries.values())

    def engages(self, owner: nn.Module, inputs: tuple) -> bool:
        x = inputs[0]
        if not (x.is_cuda and torch.is_inference_mode_enabled()) or torch.cuda.is_current_stream_capturing():
            return False
        if self._owned is None:
            self._owned = tuple(owner.parameters()), tuple(m for m in owner.modules() if m is not owner)
        params, modules = self._owned
        return not (any(p.requires_grad for p in params) or _global_hooks()
                    or any(m._forward_hooks or m._forward_pre_hooks for m in modules))

    def __call__(self, owner: nn.Module, fn: Callable, *inputs) -> torch.Tensor:
        if not self.engages(owner, inputs):
            return fn(*inputs)
        return self.run(fn, inputs)

    def run(self, fn: Callable, inputs: tuple) -> torch.Tensor:
        """`fn(*inputs)` by the capture policy, whatever the conditions."""
        key = (_build.options(), *(None if x is None else (x.device, x.dtype, x.shape, x.stride()) for x in inputs))
        if key in self._entries:
            self._entries.move_to_end(key)
            graph = self._entries[key]
            if graph is not None:
                counts["graph_replays"] += 1
                return graph.replay(inputs)
            out, self._entries[key] = self._capture(fn, inputs)
        else:
            self._entries[key] = None
            if len(self._entries) > self.limit:
                self._entries.popitem(last=False)
            out = fn(*inputs)
        counts["graph_misses"] += 1
        return out


class Graphed(nn.Module):
    """A module whose forward may replay a CUDA graph (`GraphCache`); the
    cache is dropped wherever the parameters may move."""

    def __init__(self):
        super().__init__()
        self._graphs = GraphCache()

    def _apply(self, *args, **kwargs):
        self._graphs.clear()
        return super()._apply(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._graphs.clear()
        return super().load_state_dict(*args, **kwargs)
