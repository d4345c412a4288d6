"""`experiments_torch/`, the port's twins of the experiment scripts under
`experiments/`: one twin a file, calling `diffusion_e2e_ft_tpu_torch.cli.*`
with the JAX script's arguments plus `--device "${DEVICE:-cuda}"` (the
argument files the same), and, end to end on the CPU in a temporary working
directory, the NYU pair (`11_infer_nyu.sh` -> `12_eval_nyu.sh`) and
`normals/eval_args/run_all.sh` with tiny checkpoints the port writes
(`DEVICE=cpu`, `CHECKPOINT*`, `BASE_DATA_DIR`; `run_all.sh` also
`EVAL_DATA` and `SPLIT_PATHS`, since the vendored DSINE lists name the real
frames), on the synthetic trees of `tests/test_torch_eval_cli.py` (its
DSINE nyuv2 tree) plus an NYU-layout tar of the frames the repo's NYU split
names first."""

import io
import os
import re
import shutil
import subprocess
import tarfile

import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu_torch.data import image_io
from diffusion_e2e_ft_tpu_torch.models import clip
from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, MarigoldPipeline, loading
from diffusion_e2e_ft_tpu_torch.pipelines.marigold import init_random_
from test_torch_eval_cli import write_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR, PORT_DIR = os.path.join(REPO, "experiments"), os.path.join(REPO, "experiments_torch")
DEVICE_ARG = '--device "${DEVICE:-cuda}"'
NYU_HW = (120, 160)  # inside NYU's eigen crop (rows 45-471, columns 41-601) on 120 rows and 160 columns
FRAMES = 2


def files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root) for f in files)


def invocation(path: str) -> tuple:
    """(the `python -m` module, its argument lines) of a script."""
    text = open(path).read()
    match = re.search(r"python -m (\S+)(.*)", text, re.S)
    args = [line.strip().rstrip("\\").strip() for line in match.group(2).splitlines()]
    return match.group(1), [a for a in args if a and a not in ("done",)]


@pytest.mark.parametrize("rel", files(JAX_DIR))
def test_every_experiment_script_has_its_twin(rel):
    jax_path, port_path = os.path.join(JAX_DIR, rel), os.path.join(PORT_DIR, rel)
    assert os.path.isfile(port_path) and os.access(port_path, os.X_OK) == os.access(jax_path, os.X_OK)
    if rel.endswith(".txt"):
        assert open(port_path).read() == open(jax_path).read()
        return
    if "0_infer_eval_all" in rel:  # the loop over the numbered scripts
        assert "bash" in open(port_path).read() and "cli." not in open(port_path).read()
        return
    jax_module, jax_args = invocation(jax_path)
    port_module, port_args = invocation(port_path)
    assert port_module == jax_module.replace("diffusion_e2e_ft_tpu.", "diffusion_e2e_ft_tpu_torch.", 1)
    if rel.endswith("run_all.sh"):
        assert jax_args[0].startswith('@"$args"') and port_args[0] == f'@"$args" {DEVICE_ARG}'
        return
    assert port_args == jax_args + [DEVICE_ARG]


def test_twins_cover_experiments():
    assert files(PORT_DIR) == files(JAX_DIR) and len(files(JAX_DIR)) == 38


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """`test_torch_eval_cli`'s trees (a DSINE nyuv2 tree with its split
    among them), tiny Marigold and GeoWizard checkpoints written by the
    port, an NYU tar, and a working directory holding the repo's NYU dataset
    config and a split list of the tar's frames."""
    root = tmp_path_factory.mktemp("experiments")
    paths = write_tree(str(root))
    paths["cwd"] = str(root / "cwd")
    pipe = MarigoldPipeline.from_random(seed=4, device="cpu")
    paths["ckpt"] = str(root / "marigold")
    loading.save_pipeline_dir(paths["ckpt"], pipe.unet.config, pipe.unet.state_dict(), pipe.vae.config,
                              pipe.vae.state_dict(), pipe.scheduler_config)
    text_config = clip.CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
    text = clip.CLIPTextModel(text_config)
    init_random_(text, torch.Generator().manual_seed(5))
    loading.save_text_encoder(os.path.join(paths["ckpt"], "text_encoder"), text_config, text.state_dict())
    geo = GeoWizardPipeline.from_random(seed=6, device="cpu")
    paths["geo_ckpt"] = str(root / "geowizard")
    loading.save_pipeline_dir(paths["geo_ckpt"], geo.unet.config, geo.unet.state_dict(), geo.vae.config,
                              geo.vae.state_dict(), geo.scheduler_config, image_encoder_config=geo.image_encoder.config,
                              image_encoder_state=geo.image_encoder.state_dict())
    rng = np.random.default_rng(7)
    # NYU: the repo's config as it is, its split cut to the tar's frames
    os.makedirs(os.path.join(paths["cwd"], "config", "dataset"))
    shutil.copy(os.path.join(REPO, "config", "dataset", "data_nyu_test.yaml"),
                os.path.join(paths["cwd"], "config", "dataset"))
    with open(os.path.join(REPO, "data_split", "nyu", "labeled", "filename_list_test.txt")) as f:
        lines = f.read().splitlines()[:FRAMES]
    split = os.path.join(paths["cwd"], "data_split", "nyu", "labeled", "filename_list_test.txt")
    os.makedirs(os.path.dirname(split))
    with open(split, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.makedirs(os.path.join(paths["data"], "nyuv2"))
    with tarfile.open(os.path.join(paths["data"], "nyuv2", "nyu_labeled_extracted.tar"), "w") as tar:
        for line in lines:
            rgb, depth, filled = line.split()
            mm = rng.integers(500, 9000, NYU_HW).astype(np.uint16)
            for rel, a in ((rgb, rng.integers(0, 256, (*NYU_HW, 3), dtype=np.uint8)), (depth, mm), (filled, mm)):
                blob = image_io.encode_png(a)
                info = tarfile.TarInfo("./" + rel)
                info.size = len(blob)
                tar.addfile(info, io.BytesIO(blob))
    return paths


def run_script(work, rel: str, **env) -> str:
    full = {**os.environ, "DEVICE": "cpu", "BASE_DATA_DIR": work["data"], "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
            **env}
    proc = subprocess.run(["bash", os.path.join(PORT_DIR, rel)], cwd=work["cwd"], env=full, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return proc.stdout


def test_nyu_pair_runs_on_the_cpu(work):
    family = "depth/eval_args/marigold_e2e_ft"
    run_script(work, f"{family}/11_infer_nyu.sh", CHECKPOINT=work["ckpt"])
    out = os.path.join(work["cwd"], "output", "depth", "marigold_e2e_ft", "nyu_test")
    dumps = [f for f in files(os.path.join(out, "prediction")) if f.endswith(".npy")]
    assert len(dumps) == FRAMES
    for f in dumps:
        pred = np.load(os.path.join(out, "prediction", f))
        assert pred.shape == NYU_HW and np.isfinite(pred).all() and 0 <= pred.min() and pred.max() <= 1
    args = open(os.path.join(out, "prediction", "arguments.txt")).read()
    assert "device: cpu" in args.splitlines()
    run_script(work, f"{family}/12_eval_nyu.sh")
    text = open(os.path.join(out, "eval_metric", "eval_metrics-least_square.txt")).read()
    values = {m: float(v) for m, v in re.findall(r"(\w+)\s*[:|=]?\s*([-+0-9.eE]+)\s*$", text, re.M)}
    assert {"abs_relative_difference", "delta1_acc", "silog_rmse"} <= set(values), text
    assert all(np.isfinite(v) for v in values.values())


def test_normals_run_all_runs_on_the_cpu(work):
    families = ("geowizard_e2e_ft", "marigold_e2e_ft", "stable_diffusion_e2e_ft")
    ckpts = {f"CHECKPOINT_{f}": work["geo_ckpt"] if f.startswith("geowizard") else work["ckpt"] for f in families}
    run_script(work, "normals/eval_args/run_all.sh", EVAL_DATA="nyuv2", SPLIT_PATHS=f"nyuv2={work['normal_split']}",
               **ckpts)
    for family in families:
        text = open(os.path.join(work["cwd"], "output", "normals", family, "nyuv2_metrics.txt")).read()
        numbers = [float(v) for v in re.findall(r"[-+]?\d+\.\d+(?:[eE][-+]?\d+)?", text)]
        assert len(numbers) >= 8 and all(np.isfinite(numbers)), text
