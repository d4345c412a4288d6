"""On the card, at each cell's own size and on three seeds: the fp8 control
fails the cell's limits. Skips without a CUDA device; run on the card with

    python3 -m pytest benchmark/tests/test_h100_control.py -q
"""

import json
import time

import pytest

import calibrate
import run
from lib import checks, spec
from reference.precision import FP8

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**32 + 1234567, 2**31 + 7654321, 3 * 10**9 + 11])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_at_its_size(card, cell, seed):
    c = spec.load_cell(cell)
    ctx = run.Context(c, spec.family_module(c.config["family"]), seed, 1, False, card, time.perf_counter())
    nums = calibrate.serve_control(ctx, FP8) if c.kind == "serve" else calibrate.train_control(ctx, FP8)
    assert not checks.judge(nums, c.limits), nums
