"""The port's evaluation CLIs against the JAX package's, end to end on the CPU.

One tiny Marigold HF checkpoint, written by the JAX package
(`_torch_port.write_tiny_checkpoint`), and one tiny GeoWizard checkpoint
written by the port. The port's five CLIs run in a subprocess where PIL,
cv2, PyYAML and JAX cannot be imported (the H100 host has none of them), on
synthetic trees at 48x64: `infer` (Marigold and GeoWizard) on a two-frame
ScanNet-layout tar, `eval_depth` on its dump with both alignments,
`eval_normals` on a two-frame DSINE nyuv2 tree, `run_marigold` and
`run_geowizard` on a folder of two PNGs; reading an EXR normal map (iBims)
must raise, naming cv2, and nothing else may. Then, in this process:

- the JAX `infer` CLI on the same tree: the same file names, the `.npy`
  dumps to 1e-3 (the bound `test_torch_pipeline.py` gives after the min-max
  rescale), the same `arguments.txt` keys plus `device`;
- the JAX `eval_depth` on the port's dump: each metric to 1e-5 relative, and
  `per_sample_metrics.csv` / `eval_metrics-<alignment>.txt` line for line
  (same keys, samples and order; values to 1e-5 relative);
- both packages' `normal_bench.run_benchmark` with one predicted array: the
  same metrics to 1e-5 degrees (both pool with numpy: they read equal) and
  the same `nyuv2_metrics.txt`;
- `run_marigold`'s and `run_geowizard`'s trees by the JAX CLIs' names; the
  16-bit PNGs read back through PIL equal `to_uint16(depth_np)`, the coloured
  ones the JAX colorization of the same depth.
"""

import csv
import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
from PIL import Image

import _torch_port
from diffusion_e2e_ft_tpu.cli import eval_depth as jeval_depth
from diffusion_e2e_ft_tpu.cli import infer as jinfer
from diffusion_e2e_ft_tpu.evaluation import normal_bench as jnormal_bench
from diffusion_e2e_ft_tpu.ops import image as jim
from diffusion_e2e_ft_tpu_torch.data import image_io
from diffusion_e2e_ft_tpu_torch.evaluation import normal_bench as tnormal_bench
from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, loading as tloading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (48, 64)
ALIGNMENTS = ("least_square", "least_square_disparity")
DUMP_BOUND = 1e-3
METRIC_RTOL = 1e-5

# Runs the port's CLIs with PIL, cv2, PyYAML and JAX unimportable; argv[1] is the JSON of `paths`.
PORT_RUN = """
import json, sys
for name in ("PIL", "cv2", "yaml", "jax", "jaxlib", "flax"):
    sys.modules[name] = None
p = json.loads(sys.argv[1])
from diffusion_e2e_ft_tpu_torch.cli import eval_depth, eval_normals, infer, run_geowizard, run_marigold
from diffusion_e2e_ft_tpu_torch.data.normal_eval import get_normal_dataset

cpu = ["--device", "cpu"]
tree = ["--dataset_config", p["config"], "--base_data_dir", p["data"]]
infer.main(["--checkpoint", p["ckpt"], *tree, "--output_dir", p["out"] + "/infer", *cpu])
infer.main(["--checkpoint", p["geo_ckpt"], "--model_type", "geowizard", "--domain", "outdoor", *tree,
            "--output_dir", p["out"] + "/infer_geo", *cpu])
for alignment in ("least_square", "least_square_disparity"):
    eval_depth.main([*tree, "--prediction_dir", p["out"] + "/infer", "--alignment", alignment,
                     "--output_dir", p["out"] + "/eval_" + alignment, *cpu])
eval_normals.main(["--checkpoint", p["ckpt"], "--base_data_dir", p["data"], "--eval_data", "nyuv2",
                   "--split_paths", "nyuv2=" + p["normal_split"], "--output_dir", p["out"] + "/normals", *cpu])
run_marigold.main(["--checkpoint", p["ckpt"], "--input_rgb_dir", p["images"], "--processing_res", "0",
                   "--output_dir", p["out"] + "/run_marigold", *cpu])
run_geowizard.main(["--checkpoint", p["geo_ckpt"], "--input_dir", p["images"], "--processing_res", "0",
                    "--output_dir", p["out"] + "/run_geowizard", *cpu])
try:
    get_normal_dataset("ibims", p["data"], p["exr_split"])[0]
except ImportError as e:
    assert "cv2" in str(e), e
    print("EXR raised:", e)
print("PORT RUN OK")
"""


def write_tree(root: str) -> dict:
    rng = np.random.default_rng(11)
    paths = {"data": os.path.join(root, "data"), "out": os.path.join(root, "out")}
    os.makedirs(paths["data"])
    # ScanNet layout, in a tar as the real archive: PNG frames (lossless, so both packages read equal pixels)
    lines = []
    with tarfile.open(os.path.join(paths["data"], "scannet.tar"), "w") as tar:
        for i in range(2):
            for rel, a in ((f"scene0/color/{i:06d}.png", rng.integers(0, 256, (*HW, 3), dtype=np.uint8)),
                           (f"scene0/depth/{i:06d}.png", rng.integers(300, 9000, HW).astype(np.uint16))):
                blob = image_io.encode_png(a, filter_type=i * 4)
                info = tarfile.TarInfo("./" + rel)
                info.size = len(blob)
                tar.addfile(info, io.BytesIO(blob))
            lines.append(f"scene0/color/{i:06d}.png scene0/depth/{i:06d}.png")
    paths["split"] = os.path.join(root, "scannet_list.txt")
    with open(paths["split"], "w") as f:
        f.write("\n".join(lines) + "\n")
    paths["config"] = os.path.join(root, "data_scannet.yaml")
    with open(paths["config"], "w") as f:
        f.write(f"name: scannet\ndisp_name: scannet_val\ndir: scannet.tar\nfilenames: {paths['split']}\n")
    # DSINE nyuv2 layout with a local split, and an iBims frame whose normals are EXR
    for name in ("nyuv2", "ibims"):
        scene = os.path.join(paths["data"], "dsine_eval", name, "scene0")
        os.makedirs(scene)
        for i in range(2 if name == "nyuv2" else 1):
            image_io.write_png(os.path.join(scene, f"{i:04d}_img.png"), rng.integers(0, 256, (*HW, 3), dtype=np.uint8))
            n = rng.normal(size=(*HW, 3))
            n8 = ((n / np.linalg.norm(n, axis=-1, keepdims=True) + 1) / 2 * 255).astype(np.uint8)
            n8[:2, :3] = 0
            image_io.write_png(os.path.join(scene, f"{i:04d}_normal.png"), n8)
        with open(os.path.join(scene, "0000_normal.exr"), "wb") as f:
            f.write(b"\x76\x2f\x31\x01")
        split = os.path.join(paths["data"], "dsine_eval", name, "test.txt")
        with open(split, "w") as f:
            f.write("".join(f"scene0/{i:04d}_img.png\n" for i in range(2 if name == "nyuv2" else 1)))
        paths["normal_split" if name == "nyuv2" else "exr_split"] = split
    paths["images"] = os.path.join(root, "images")
    os.makedirs(paths["images"])
    for stem in ("a", "b"):
        image_io.write_png(os.path.join(paths["images"], f"{stem}.png"), rng.integers(0, 256, (*HW, 3), dtype=np.uint8))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The trees, both checkpoints, and the port's CLI runs (a subprocess
    with PIL, cv2, PyYAML and JAX blocked); returns the paths and its stdout."""
    root = str(tmp_path_factory.mktemp("eval_cli"))
    paths = write_tree(root)
    paths["ckpt"] = _torch_port.write_tiny_checkpoint(os.path.join(root, "ckpt"))
    geo = GeoWizardPipeline.from_random(seed=3, device="cpu")
    paths["geo_ckpt"] = os.path.join(root, "geo_ckpt")
    tloading.save_pipeline_dir(paths["geo_ckpt"], geo.unet.config, geo.unet.state_dict(), geo.vae.config,
                               geo.vae.state_dict(), geo.scheduler_config,
                               image_encoder_config=geo.image_encoder.config,
                               image_encoder_state=geo.image_encoder.state_dict())
    proc = subprocess.run([sys.executable, "-c", PORT_RUN, json.dumps(paths)], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return paths, proc.stdout


def test_port_clis_run_without_pil_cv2_yaml(runs):
    _, stdout = runs
    assert "EXR raised" in stdout and "needs cv2" in stdout and stdout.rstrip().endswith("PORT RUN OK")


@pytest.fixture(scope="module")
def jax_dump(runs):
    paths, _ = runs
    out = os.path.join(paths["out"], "jax_infer")
    jinfer.main(["--checkpoint", paths["ckpt"], "--dataset_config", paths["config"],
                 "--base_data_dir", paths["data"], "--output_dir", out])
    return out


def test_infer_dump_matches_jax(runs, jax_dump):
    paths, _ = runs
    port = os.path.join(paths["out"], "infer")
    names = sorted(f for f in os.listdir(jax_dump) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(port) if f.endswith(".npy")) == ["pred_000000.npy", "pred_000001.npy"]
    for name in names:
        got, want = np.load(os.path.join(port, name)), np.load(os.path.join(jax_dump, name))
        assert got.shape == want.shape == HW and got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=DUMP_BOUND, rtol=0)

    def arguments(d):
        with open(os.path.join(d, "arguments.txt")) as f:
            return dict(line.rstrip("\n").split(": ", 1) for line in f)

    got, want = arguments(port), arguments(jax_dump)
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert {k: v for k, v in got.items() if k not in ("device", "output_dir")} == \
           {k: v for k, v in want.items() if k != "output_dir"}


def _read_txt(path: str) -> list:
    with open(path) as f:
        return [(line.split()[0], float(line.split()[1])) for line in f]


@pytest.mark.parametrize("alignment", ALIGNMENTS)
def test_eval_depth_matches_jax(runs, alignment):
    paths, _ = runs
    out = os.path.join(paths["out"], "jax_eval_" + alignment)
    jeval_depth.main(["--dataset_config", paths["config"], "--base_data_dir", paths["data"],
                      "--prediction_dir", os.path.join(paths["out"], "infer"), "--alignment", alignment,
                      "--output_dir", out])
    port = os.path.join(paths["out"], "eval_" + alignment)
    assert sorted(os.listdir(port)) == sorted(os.listdir(out)) == sorted(
        ["per_sample_metrics.csv", f"eval_metrics-{alignment}.txt"])
    got, want = _read_txt(os.path.join(port, f"eval_metrics-{alignment}.txt")), \
        _read_txt(os.path.join(out, f"eval_metrics-{alignment}.txt"))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 10
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=METRIC_RTOL, atol=1e-8)
    with open(os.path.join(port, "per_sample_metrics.csv")) as f:
        got = list(csv.reader(f))
    with open(os.path.join(out, "per_sample_metrics.csv")) as f:
        want = list(csv.reader(f))
    assert got[0] == want[0] and [r[0] for r in got] == [r[0] for r in want] and len(got) == 3
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float), np.array([r[1:] for r in want[1:]], float),
                               rtol=METRIC_RTOL)


def test_eval_normals_matches_jax(runs, tmp_path):
    paths, stdout = runs
    rng = np.random.default_rng(12)
    pred = rng.normal(size=(*HW, 3)).astype(np.float32)
    pred /= np.linalg.norm(pred, axis=-1, keepdims=True)
    seen = []

    def predict(img01, domain):
        seen.append((img01.shape, domain))
        return pred

    split = {"nyuv2": paths["normal_split"]}
    got = tnormal_bench.run_benchmark(paths["data"], predict, str(tmp_path / "t"), ["nyuv2"], split)["nyuv2"]
    want = jnormal_bench.run_benchmark(paths["data"], predict, str(tmp_path / "j"), ["nyuv2"], split)["nyuv2"]
    assert seen == [((*HW, 3), "indoor")] * 4
    assert list(got) == list(want) == ["mean", "median", "rmse", "a1", "a2", "a3", "a4", "a5"]
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=0, atol=1e-5)
    with open(tmp_path / "t" / "nyuv2_metrics.txt") as f, open(tmp_path / "j" / "nyuv2_metrics.txt") as g:
        assert f.read() == g.read()
    # the port's CLI run (a tiny Marigold's normals) wrote eight finite values
    with open(os.path.join(paths["out"], "normals", "nyuv2_metrics.txt")) as f:
        header, values = f.read().split("\n")[:2]
    assert header.split() == list(want) and len(values.split()) == 8
    assert all(np.isfinite(float(v)) for v in values.split())


def test_geowizard_dump(runs):
    paths, _ = runs
    out = os.path.join(paths["out"], "infer_geo")
    for i in range(2):
        d = np.load(os.path.join(out, f"pred_{i:06d}.npy"))
        assert d.shape == HW and d.dtype == np.float32 and np.isfinite(d).all() and 0 <= d.min() <= d.max() <= 1
    with open(os.path.join(out, "arguments.txt")) as f:
        text = f.read()
    assert "model_type: geowizard" in text and "domain: outdoor" in text


def test_run_cli_trees(runs):
    paths, _ = runs
    marigold = os.path.join(paths["out"], "run_marigold")
    geowizard = os.path.join(paths["out"], "run_geowizard")
    depth_files = {"depth_npy": "{}_pred.npy", "depth_colored": "{}_colored.png", "depth_bw": "{}_bw.png"}
    normal_files = {"normal_npy": "{}_pred.npy", "normal_colored": "{}_colored.png"}
    for root, layout in ((marigold, depth_files), (geowizard, {**depth_files, **normal_files})):
        assert sorted(os.listdir(root)) == sorted([*layout, "arguments.txt"])
        for sub, pattern in layout.items():
            assert sorted(os.listdir(os.path.join(root, sub))) == [pattern.format(s) for s in ("a", "b")]
        for stem in ("a", "b"):
            depth = np.load(os.path.join(root, "depth_npy", f"{stem}_pred.npy"))
            assert depth.shape == HW
            bw = np.asarray(Image.open(os.path.join(root, "depth_bw", f"{stem}_bw.png")))
            assert bw.dtype == np.uint16
            np.testing.assert_array_equal(bw, jim.to_uint16(depth))
            colored = np.asarray(Image.open(os.path.join(root, "depth_colored", f"{stem}_colored.png")))
            np.testing.assert_array_equal(colored, (jim.colorize_depth(depth) * 255).astype(np.uint8))
    normals = np.load(os.path.join(geowizard, "normal_npy", "a_pred.npy"))
    colored = np.asarray(Image.open(os.path.join(geowizard, "normal_colored", "a_colored.png")))
    np.testing.assert_array_equal(colored, jim.colorize_normals(normals))
    assert normals.shape == (*HW, 3)
