"""The reader of `graph_hit_share.serve` on hand-made traced windows: the
share over the requests that carry the program's graph counters, nothing
where none does, and nothing from a program without the recorder."""

import sys

import pytest

from diffusion_e2e_ft_tpu_torch.utils import trace
from lib import spec

MS = 1_000_000
METRIC = "graph_hit_share.serve"


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def window(*attrs) -> dict:
    """One request span a 100 ms, from 100 ms on, with the counters `attrs[i]`."""
    for i, a in enumerate(attrs):
        rid = i + 1
        trace.BUFFER.add(trace.Span("request", rid, None, rid, (100 + 100 * i) * MS, (150 + 100 * i) * MS, a))
    return {"w0": 0, "w1": 1000 * MS, "ops": [], "spans": {}}


def test_the_share_of_replays_over_the_traced_requests():
    rec = window({"syncs": 8, "allocs": 0, "graph_replays": 2, "graph_misses": 0},
                 {"syncs": 8, "allocs": 0, "graph_replays": 1, "graph_misses": 1}, None)
    assert spec.metric_reader(METRIC).read(rec) == pytest.approx(75.0)


def test_all_replays_read_100_and_no_graphed_call_reads_nothing():
    assert spec.metric_reader(METRIC).read(window({"graph_replays": 3, "graph_misses": 0})) == pytest.approx(100.0)
    trace.clear()
    assert spec.metric_reader(METRIC).read(window({"graph_replays": 0, "graph_misses": 0})) is None


def test_requests_without_the_counters_read_nothing():
    assert spec.metric_reader(METRIC).read(window({"syncs": 9, "allocs": 0}, None)) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    rec = window({"graph_replays": 2, "graph_misses": 0})
    monkeypatch.setitem(sys.modules, "diffusion_e2e_ft_tpu_torch.utils.trace", None)
    assert spec.metric_reader(METRIC).read(rec) is None
