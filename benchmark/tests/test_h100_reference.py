"""The plain reference against the program at tiny sizes on the CPU (the
program's plain float32 path), the control and the faults that `correct`
has to reject, each through a whole run of the harness."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

import calibrate
import run
import tiny
from lib import checks, spec
from reference.precision import FP8

SEED = 2**31 + 2**20 + 7


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def run_cell(root, cell, seconds=1):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds), "--trace", "0"],
                      root=root, device=torch.device("cpu"))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [c[0] for c in tiny.CELLS])
def test_the_program_agrees_with_the_reference(root, cell):
    result = run_cell(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def _ctx(root, cell):
    c = spec.load_cell(cell, root)
    return run.Context(c, spec.family_module(c.config["family"]), SEED, 1, False, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("cell", [c[0] for c in tiny.CELLS])
def test_the_fp8_control_is_not_correct(root, cell):
    ctx = _ctx(root, cell)
    nums = calibrate.serve_control(ctx, FP8) if ctx.cell.kind == "serve" else calibrate.train_control(ctx, FP8)
    assert not checks.judge(nums, ctx.cell.limits), nums


def test_an_altered_answer_is_not_correct(root, monkeypatch):
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    infer = MarigoldPipeline.infer
    monkeypatch.setattr(MarigoldPipeline, "infer", lambda self, *a, **k: infer(self, *a, **k).flip(-1))
    assert not run_cell(root, "tiny_marigold_serve")["correct"]


@pytest.mark.parametrize("cell", ["tiny_marigold_serve", "tiny_geowizard_serve"])
def test_a_groupnorm_that_ignores_its_affine_is_not_correct(root, monkeypatch, cell):
    from diffusion_e2e_ft_tpu_torch.models import layers

    gn = layers.group_norm_silu
    monkeypatch.setattr(layers, "group_norm_silu",
                        lambda x, w, b, *a, **k: gn(x, torch.ones_like(w), torch.zeros_like(b), *a, **k))
    assert not run_cell(root, cell)["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(root, monkeypatch):
    from diffusion_e2e_ft_tpu_torch.training import optim

    monkeypatch.setattr(optim.OptaxAdamW, "_apply", lambda self, grads, state, params, norm_of=None: None)
    result = run_cell(root, "tiny_marigold_train")
    assert not result["correct"] and result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell,trainer", [("tiny_marigold_train", "E2ETrainer"),
                                          ("tiny_geowizard_train", "GeoWizardTrainer")])
def test_half_the_batch_left_out_is_not_correct(root, monkeypatch, cell, trainer):
    from diffusion_e2e_ft_tpu_torch.training import geowizard, trainer as tr

    cls = getattr(tr if trainer == "E2ETrainer" else geowizard, trainer)
    loss = cls.loss

    def half(self, batch, *a, **k):
        return loss(self, {key: v[: len(v) // 2] if key != "domain" else v for key, v in batch.items()}, *a, **k)

    monkeypatch.setattr(cls, "loss", half)
    assert not run_cell(root, cell)["correct"]
