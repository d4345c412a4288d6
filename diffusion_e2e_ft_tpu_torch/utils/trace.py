"""Spans and counters of the serving path, recorded only while a PyTorch
profiler session runs.

A span is (name, span id, parent id, request id, t0_ns, t1_ns, attrs) on the
`time.time_ns()` clock, the clock of the profiler's (kineto's) timestamps, so
each span can be set against the device's kernel intervals of the same
trace. `span(name)` is the context manager and `traced(name)` its decorator
form. Parents come from a per-thread stack (`cli/serve.py` serves each
connection on a thread of its own); the outermost span of a call opens a
request id that every span inside it shares. `request(device)` opens the `request` span where no
span is open on the thread, and on a CUDA device gives it two counters:
`syncs`, the host-device synchronisations made inside it (those PyTorch's
CUDA sync debug mode reports: copies between the card and pageable host
memory, `.item()`, `.tolist()`, stream synchronisations;
`torch.cuda.synchronize()` is not among them), and `allocs`, the caching
allocator's device calls (`cudaMalloc`, `cudaFree`, retries), and two of
`utils/graphs.py`: `graph_replays`, the graphed modules' calls served by a
CUDA graph's replay, and `graph_misses`, those that ran eagerly where a
graph could serve them. All are process-wide, so another thread's work
during the request counts too, and one request at a time counts them.

The gate is the profiler's own Python flag, raised and lowered by every
`torch.autograd.profiler.profile` and `torch.profiler.profile` session.
Outside one, `span` and `request` return one shared no-op context and a
`traced` function calls straight through: no clock is read and nothing is
recorded. Spans go to a bounded in-memory buffer (`spans`, `dropped`,
`clear`); nothing is written on the hot path.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
import warnings
from typing import List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

from diffusion_e2e_ft_tpu_torch.utils import graphs

LIMIT = 1 << 16  # spans kept: ~8 a request, so the last ~8,000 requests
SYNC_WARNING = "synchronizing CUDA operation"  # the sync debug mode's message


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: Optional[int]
    request_id: int
    t0_ns: int
    t1_ns: int
    attrs: Optional[dict]


class SpanBuffer:
    """The last `limit` spans closed, oldest first, and how many older ones
    were dropped to keep that bound."""

    def __init__(self, limit: int):
        self._spans: collections.deque = collections.deque(maxlen=limit)
        self._dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0


BUFFER = SpanBuffer(LIMIT)
_ids = itertools.count(1)
_local = threading.local()
_COUNTING = threading.Lock()  # held by the request whose counters run


def spans() -> List[Span]:
    return BUFFER.spans()


def dropped() -> int:
    return BUFFER.dropped()


def clear() -> None:
    BUFFER.clear()


def recording() -> bool:
    """Whether a profiler session is running, so spans are recorded."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "_id", "_parent", "_request", "_t0")

    def __init__(self, name: str):
        self.name, self.attrs = name, None

    def __enter__(self):
        stack = _stack()
        self._id = next(_ids)
        self._parent, self._request = (stack[-1]._id, stack[-1]._request) if stack else (None, self._id)
        stack.append(self)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._close(time.time_ns())
        return False

    def _close(self, t1: int) -> None:
        _stack().pop()
        BUFFER.add(Span(self.name, self._id, self._parent, self._request, self._t0, t1, self.attrs))


def span(name: str):
    """A span named `name` over the `with` block while a profiler runs; else the shared no-op."""
    return _Span(name) if _profiler._is_profiler_enabled else _NO_SPAN


def traced(name: str):
    """Decorator: each call of the function runs inside `span(name)`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _alloc_calls(device: torch.device) -> int:
    s = torch.cuda.memory_stats_as_nested_dict(device)  # these three at its top; `memory_stats` flattens it all
    return s.get("num_device_alloc", 0) + s.get("num_device_free", 0) + s.get("num_alloc_retries", 0)


class _Request(_Span):
    """The `request` span; on a CUDA device it counts `syncs`, `allocs`,
    `graph_replays` and `graph_misses` between its open and its close (the
    counting itself outside its times). The modes it sets are process-wide,
    so one request at a time counts: a request opened on another thread
    meanwhile records no counters."""

    __slots__ = ("_device", "_mode", "_warnings", "_caught", "_allocs", "_graphs")

    def __init__(self, device: Optional[torch.device]):
        super().__init__("request")
        self._device = device

    def __enter__(self):
        if self._device is not None and not _COUNTING.acquire(blocking=False):
            self._device = None
        if self._device is not None:
            self._mode = torch.cuda.get_sync_debug_mode()
            self._warnings = warnings.catch_warnings(record=True)
            self._caught = self._warnings.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            self._allocs = _alloc_calls(self._device)
            self._graphs = dict(graphs.counts)
        return super().__enter__()

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self._device is not None:
            try:
                allocs = _alloc_calls(self._device) - self._allocs
                torch.cuda.set_sync_debug_mode(self._mode)
                self._warnings.__exit__(*exc)
            finally:
                _COUNTING.release()
            syncs = 0
            for w in self._caught:
                if SYNC_WARNING in str(w.message):
                    syncs += 1
                else:  # not ours to swallow
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno, source=w.source)
            self.attrs = {"syncs": syncs, "allocs": allocs,
                          **{k: n - self._graphs[k] for k, n in graphs.counts.items()}}
        self._close(t1)
        return False


def request(device=None):
    """The `request` span while a profiler runs and no span is open on this
    thread (a pipeline's `__call__` under `PipelineService.predict` is the
    same request); else the shared no-op. `device` is where the request runs:
    on a CUDA device the span counts `syncs`, `allocs`, `graph_replays` and
    `graph_misses`."""
    if not _profiler._is_profiler_enabled or _stack():
        return _NO_SPAN
    device = torch.device(device) if device is not None else None
    return _Request(device if device is not None and device.type == "cuda" else None)
