"""The readers of the program's own spans (`lib/program.py` and the metrics
that use it) on a hand-made traced window, on a program without the
recorder, and through traced runs of the tiny serving cells on the CPU; and
the program's spans against the harness's own in a traced window, on the
CPU and (marked `card`) at full size on the card."""

import io
import json
import sys
import time
from contextlib import redirect_stdout

import pytest
import torch

import run
import tiny
from diffusion_e2e_ft_tpu_torch.utils import trace
from kinds import serve
from lib import program, spec

MS = 1_000_000
PROGRAM_METRICS = ["pre_ms.serve", "post_ms.serve", "unet_host_ms.serve", "vae_host_ms.serve", "clip_host_ms.serve",
                   "device_lag_ms.serve", "syncs.serve", "allocs.serve"]
COUNTERS = {"syncs.serve", "allocs.serve"}


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def add_request(rid: int, t: int, spans: dict, attrs=None) -> None:
    """A request opened at t ms with child spans {name: [(t0, t1) ms after t]}, all under the root."""
    ids = iter(range(rid * 100 + 1, rid * 100 + 100))
    end = max(b for ivs in spans.values() for _, b in ivs) + 1
    root = trace.Span("request", rid * 100, None, rid * 100, t * MS, (t + end) * MS, attrs)
    for name, ivs in spans.items():
        for a, b in ivs:
            trace.BUFFER.add(trace.Span(name, next(ids), root.span_id, root.request_id, (t + a) * MS, (t + b) * MS, None))
    trace.BUFFER.add(root)


def window() -> dict:
    """Two requests in [0, 1000] ms and one after it; the device's operations as (name, start, duration) in ns.

    Request 1 (at 100 ms): its last operation before `post` (at 160) ends 8 ms after `infer` (at 150).
    Request 2 (at 400 ms): its last operation ends before `infer` does: a lag of 0, not -5."""
    body = {"pre": [(0, 10)], "infer": [(10, 50)], "encode": [(12, 18)], "unet": [(20, 40)], "decode": [(41, 49)],
            "post": [(60, 90)]}
    add_request(1, 100, body, {"syncs": 2, "allocs": 4})
    add_request(2, 400, {**body, "image_encoder": [(19, 24)]}, {"syncs": 4, "allocs": 0})
    add_request(3, 1500, body, {"syncs": 100, "allocs": 100})
    ops = [("k", 115 * MS, 10 * MS), ("k", 150 * MS, 8 * MS), ("k", 175 * MS, 1 * MS),
           ("k", 420 * MS, 25 * MS), ("k", 470 * MS, 2 * MS)]
    return {"w0": 0, "w1": 1000 * MS, "ops": ops, "spans": {}}


EXPECTED = {"pre_ms.serve": 10.0, "post_ms.serve": 30.0, "unet_host_ms.serve": 20.0, "vae_host_ms.serve": 14.0,
            "clip_host_ms.serve": 2.5, "device_lag_ms.serve": 4.0, "syncs.serve": 3.0, "allocs.serve": 2.0}


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_each_reader_on_a_hand_made_window(metric):
    rec = window()
    assert spec.metric_reader(metric).read(rec) == pytest.approx(EXPECTED[metric])
    assert len(program.requests(rec)) == 2


def test_a_window_without_program_requests_reads_nothing():
    rec = window()
    trace.clear()
    assert all(spec.metric_reader(m).read(rec) is None for m in PROGRAM_METRICS)


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_a_program_without_the_recorder_reads_none(metric, monkeypatch):
    rec = window()
    monkeypatch.setitem(sys.modules, "diffusion_e2e_ft_tpu_torch.utils.trace", None)  # as the parent commit
    assert spec.metric_reader(metric).read(rec) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,reported", [
    ("tiny_marigold_serve", set(PROGRAM_METRICS) - COUNTERS - {"clip_host_ms.serve"}),
    ("tiny_geowizard_serve", set(PROGRAM_METRICS) - COUNTERS),
])
def test_a_traced_tiny_run_reports_the_program_metrics(root, cell, reported):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "3000000019", "--seconds", "1", "--trace", "1"], root=root,
                      device=torch.device("cpu"))
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    got = {m for m in PROGRAM_METRICS if m in result["metrics"]}
    assert got == reported  # the counters run on a CUDA device only
    assert all(result["metrics"][m]["value"] >= 0 for m in got)
    assert result["metrics"]["unet_host_ms.serve"]["value"] > 0


def traced_window(cell, root, device, seconds):
    """The `rec` of a traced window of `cell`, run by `kinds/serve.py`."""
    c = spec.load_cell(cell, root)
    ctx = run.Context(c, spec.family_module(c.config["family"]), 3000000019, seconds, True, device, time.perf_counter())
    return serve.run(ctx)


def check_one_clock(rec):
    """Each program `unet` and `infer` span lies inside the harness's span of the same call, and the harness's
    `request` spans hold the program's: the program's spans and the harness's are on one clock."""
    reqs = program.requests(rec)
    assert reqs and len(reqs) == len(rec["spans"]["request"])
    for name in ("unet", "infer", "request"):
        harness = sorted(rec["spans"][name])
        ours = sorted(iv for r in reqs for iv in r["spans"][name])
        assert len(ours) == len(harness), name
        for (a, b), (s, e) in zip(ours, harness):
            assert s <= a <= b <= e, (name, (a, b), (s, e))


@pytest.mark.parametrize("cell", ["tiny_marigold_serve", "tiny_geowizard_serve"])
def test_the_program_spans_lie_inside_the_harness_spans(root, cell):
    check_one_clock(traced_window(cell, root, torch.device("cpu"), 1))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["marigold_serve_saturated", "geowizard_serve_saturated"])
def test_on_the_card_the_program_spans_lie_inside_the_harness_spans(card, cell):
    rec = traced_window(cell, tiny.ROOT, card, 3)
    check_one_clock(rec)
    for r in program.requests(rec):
        assert set(r["attrs"]) == {"syncs", "allocs"} and r["attrs"]["syncs"] >= 1, r["attrs"]
