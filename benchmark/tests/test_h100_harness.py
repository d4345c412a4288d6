"""The harness finds every cell, config, traffic mix and metric by name from
files alone; BENCHMARK.json keeps to the benchmark's contract; a run
without a card prints no result; nothing under `benchmark/` imports JAX or
the JAX package, and the reference imports nothing of the port."""

import ast
import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

import run
import tiny
from lib import spec

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_from_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    kind, fam = spec.kind_module(c.kind), spec.family_module(c.config["family"])
    assert callable(kind.run) and callable(kind.work_of)
    assert callable(getattr(fam, "build_serving" if c.kind == "serve" else "build_training"))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_agrees_with_benchmark_json(metric):
    entry = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}[metric]
    mod = spec.metric_reader(metric)
    assert callable(mod.read)
    assert (mod.SOURCE, mod.UNIT, mod.BETTER) == (entry["source"], entry["unit"], entry["better"])
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[part]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in E2E and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m["workloads"]:  # each cell it names reports the metric it moves
            assert m["moves"] in {e["name"] for e in spec.load_cell(cell).end_to_end}


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    root = tiny.make_root(tmp_path, extra_metric="dummy_window_s")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "tiny_marigold_serve", "--seed", "4294967311", "--seconds", "1", "--trace", "1"],
                      root=root, device=torch.device("cpu"))
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and result["correct"]
    assert result["metrics"]["dummy_window_s"]["value"] > 0
    assert list(result)[-1] == "checks"


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "marigold_serve_mix",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_forbidden_modules_are_found_by_whole_top_level_name():
    mods = {"jax.numpy": 1, "jaxlib": 1, "flax.linen": 1, "diffusion_e2e_ft_tpu.models": 1,
            "diffusion_e2e_ft_tpu_torch.models": 1, "jaxtyping": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == ["diffusion_e2e_ft_tpu.models", "flax.linen", "jax.numpy", "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = [p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.relative_to(ROOT / "benchmark").parts]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = set(_imports(path))
    assert not names & set(run.FORBIDDEN), path
    if "reference" in path.relative_to(ROOT / "benchmark").parts:
        assert "diffusion_e2e_ft_tpu_torch" not in names, path
