"""The SDXL cell's pieces on the CPU: the readers of the scheduler's host ms
and of the device's idle gaps between UNet calls on a hand-made traced
window, and a tiny SDXL-shaped cell run end to end through `run.main`
(the family, the reference, the work counted, the two readers), as the SDXL
cell would join the benchmark: by files and entries alone. (The cell itself
waits for the harness changes that PERF.md's open questions name.)"""

import io
import json
import sys
from contextlib import redirect_stdout

import pytest
import torch

import run
import tiny
from diffusion_e2e_ft_tpu_torch.utils import trace
from lib import program, spec

MS = 1_000_000
NEW = ["sched_host_ms.serve", "step_gap_ms.serve"]


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def add_request(rid: int, t: int, spans: dict, attrs=None) -> None:
    ids = iter(range(rid * 100 + 1, rid * 100 + 100))
    end = max(b for ivs in spans.values() for _, b in ivs) + 1
    root = trace.Span("request", rid * 100, None, rid * 100, t * MS, (t + end) * MS, attrs)
    for name, ivs in spans.items():
        for a, b in ivs:
            trace.BUFFER.add(trace.Span(name, next(ids), root.span_id, root.request_id, (t + a) * MS, (t + b) * MS, None))
    trace.BUFFER.add(root)


def window() -> dict:
    """Request 1 (at 100 ms): UNet calls at 10-12, 30-32, 50-52 ms, scheduler updates at 12-20 and 32-36.
    The device runs the first call's work 12-25 (past its host span's end: no gap there), idles 25-28,
    runs the update 28-29, idles 29-31, runs the second call 31-40 (the first op after its span opens),
    idles 40-41, runs the update 41-45, idles 45-53, runs the third call from 53: gaps 3 + 2 = 5 ms,
    then 1 + 8 = 9 ms, 14 ms in all. A copy from the host ends at 16 and at 33.5, inside each update's
    span: their host ms are 20 - 16 = 4 and 36 - 33.5 = 2.5. Request 2 (at 400 ms): one UNet call, no
    gap to read, and an update with no copy, counted whole (2 ms). Request 3 (at 600 ms): request 1
    again."""
    steps = {"infer": [(5, 80)], "unet": [(10, 12), (30, 32), (50, 52)], "scheduler": [(12, 20), (32, 36)]}
    add_request(1, 100, steps)
    add_request(2, 400, {"infer": [(5, 30)], "unet": [(10, 12)], "scheduler": [(12, 14)]})
    add_request(3, 600, steps, {"syncs": 1})
    first = ((12, 13), (28, 1), (31, 9), (41, 4), (53, 10))
    ops = [("k", (t0 + t) * MS, d * MS) for t0 in (100, 600) for t, d in first] + [("k", 412 * MS, 30 * MS)]
    ops += [("Memcpy HtoD (Pageable -> Device)", int((t0 + t) * MS), MS // 2) for t0 in (100, 600)
            for t in (15.5, 33)]
    return {"w0": 0, "w1": 1000 * MS, "ops": sorted(ops, key=lambda o: o[1]), "spans": {}}


def test_the_readers_on_a_hand_made_window():
    rec = window()
    assert spec.metric_reader("step_gap_ms.serve").read(rec) == pytest.approx(14.0)
    assert spec.metric_reader("sched_host_ms.serve").read(rec) == pytest.approx((4 + 2.5 + 2 + 4 + 2.5) / 3)
    assert len(program.requests(rec)) == 3


def test_the_step_gaps_read_nothing_once_the_span_buffer_dropped_spans(monkeypatch):
    rec = window()
    monkeypatch.setattr(trace, "dropped", lambda: 1)
    assert spec.metric_reader("step_gap_ms.serve").read(rec) is None
    assert spec.metric_reader("sched_host_ms.serve").read(rec) is not None


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    add_request(1, 100, {"infer": [(5, 80)], "unet": [(10, 12)]}, {"syncs": 1})
    rec = {"w0": 0, "w1": 1000 * MS, "ops": [("k", 112 * MS, MS)], "spans": {}}
    assert all(spec.metric_reader(m).read(rec) is None for m in NEW)
    monkeypatch.setitem(sys.modules, "diffusion_e2e_ft_tpu_torch.utils.trace", None)
    assert all(spec.metric_reader(m).read(window()) is None for m in NEW)


def tiny_sdxl_root(tmp):
    root = tiny.make_root(tmp)
    cfg = json.loads((tiny.BENCH_DIR / "configs" / "marigold_sdxl_depth.json").read_text())
    cfg["name"] = "tiny_marigold_sdxl_depth"
    cfg["unet"].update(block_out_channels=[32, 64, 64], attention_head_dim=[2, 2, 4], cross_attention_dim=32,
                       transformer_layers_per_block=[1, 2, 3], norm_num_groups=8, addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=16 + 6 * 8)
    cfg["vae"].update(tiny.TINY_VAE)
    cfg["text_context_shape"], cfg["pooled_text_shape"] = [1, 4, 32], [1, 16]
    cfg["serve"].update(processing_res=32, dtype="float32")
    path = "benchmark/configs/tiny_marigold_sdxl_depth.json"
    (root / path).write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "file": path, "reduced": [], "why": "tiny"})
    cell = "tiny_marigold_sdxl_serve"
    bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": "tiny_closed", "chips": 1, "why": "tiny"})
    (root / "benchmark" / "workloads" / f"{cell}.json").write_text(json.dumps({"limits": {"depth_mae": 1e-3}}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny_marigold_serve" in m.get("workloads", ()):
            m["workloads"].append(cell)
    for name in NEW:  # the readers' entries, which join BENCHMARK.json with the SDXL cell
        reader = spec.metric_reader(name)
        bench["per_layer"].append({"name": name, "unit": reader.UNIT, "better": reader.BETTER, "source": reader.SOURCE,
                                   "layer": reader.LAYER, "moves": reader.MOVES, "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, cell


def test_a_tiny_sdxl_cell_runs_by_files_alone(tmp_path):
    root, cell = tiny_sdxl_root(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", "4294967311", "--seconds", "1", "--trace", "1"], root=root,
                      device=torch.device("cpu"))
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"] and result["failed"] == 0
    metrics = result["metrics"]
    assert metrics["sched_host_ms.serve"]["value"] > 0 and metrics["step_gap_ms.serve"]["value"] >= 0
    assert metrics["unet_host_ms.serve"]["value"] > 0 and metrics["mfu.serve"]["value"] > 0
