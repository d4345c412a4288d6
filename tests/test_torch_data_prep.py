"""Slice E2's data preparation against the JAX package's, on the CPU.

- D2NT (`tools/depth_to_normal.py`), versions basic, v2 and v3, on a plane
  and a slope (every MRF cost tied), a depth step, a random field at 64x96
  and one 375x1242 frame: the port's float64 normals within 1e-9 of the JAX
  tool's float64 ones (its public pieces, before its float32 cast), its
  float32 output equal to the JAX tool's, and the MRF choice equal to
  `np.argmin` of the JAX tool's costs on every pixel (on the plane every
  cost ties and each pixel takes its first candidate in frame).
- The 16-bit normal PNG: the port's file decodes to the values of the JAX
  tool's cv2 file, and each package's loader reads the other's file.
- Hypersim: `tone_map`, `dist_to_depth` and `preprocess_frame` on a frame,
  a dark frame (scale 0) and an all-invalid mask (scale 1): rgb within 1
  level, depth within 1 mm, planar depth and the tone map within 1e-6.
  `cli.preprocess_hypersim` on an h5py tree gives the JAX CLI's PNGs
  (decoded, within the same bounds) and CSV, byte for byte.
- `cli.gen_vkitti_normals` writes the JAX tool's paths with the same values.
- The training readers, on the trees the port's tools wrote (and a CSV
  pandas wrote): every field of every sample equals the JAX readers' from
  the same seed; that covers PIL's high-byte read of the 16-bit normals,
  the `csv`-parsed CSV and the cv2-free depth.
- A tiny `cli.train --modality normals --device cpu` on those trees, and
  the entry points raising for want of a card without `--device`.
- `scripts/torch_train_*.sh` carry the JAX scripts' flags to the port's
  CLI; `scripts/torch_prepare_data.sh` prepares both trees on the CPU.
"""

import os
import shlex
import shutil
import sys

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from _torch_port import write_tiny_checkpoint
from diffusion_e2e_ft_tpu.cli import preprocess_hypersim as jpre_cli
from diffusion_e2e_ft_tpu.data import train_datasets as jtd
from diffusion_e2e_ft_tpu.tools import depth_to_normal as jd2n
from diffusion_e2e_ft_tpu.tools import hypersim_preprocess as jhp
from diffusion_e2e_ft_tpu.tools import make_splits as jsplits
from diffusion_e2e_ft_tpu_torch.cli import gen_vkitti_normals, preprocess_hypersim
from diffusion_e2e_ft_tpu_torch.cli import train as train_cli
from diffusion_e2e_ft_tpu_torch.data import image_io
from diffusion_e2e_ft_tpu_torch.data import train_datasets as ttd
from diffusion_e2e_ft_tpu_torch.tools import depth_to_normal as td2n
from diffusion_e2e_ft_tpu_torch.tools import hypersim_preprocess as thp
from diffusion_e2e_ft_tpu_torch.tools import make_splits as tsplits

INTRINSICS = jd2n.VKITTI_INTRINSICS
VKITTI_HW = (375, 1242)


def _depth_cases() -> dict:
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float64)
    return {
        "plane": np.full((64, 96), 1500.0),
        "slope": 500.0 + 3.0 * xx + 2.0 * yy,
        "step": np.where(xx > 40, 3000.0, 1000.0) + yy,
        "random": rng.integers(100, 8000, (64, 96)).astype(np.float64),
        "frame": rng.integers(100, 8000, VKITTI_HW).astype(np.float64),
    }


DEPTHS = _depth_cases()


def _jax_normals64(depth: np.ndarray, version: str) -> np.ndarray:
    """The JAX tool's `depth_to_normal` before its float32 cast, from its public pieces."""
    fx, fy, cx, cy = INTRINSICS
    z = np.asarray(depth, np.float64)
    h, w = z.shape
    u = np.arange(1, w + 1)[None, :] - cx
    v = np.arange(1, h + 1)[:, None] - cy
    gu, gv = jd2n.central_gradients(z) if version == "basic" else jd2n.dag_gradients(z)
    n = np.stack([gu * fx, gv * fy, -(z + v * gv + u * gu)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    if version == "v3":
        n = jd2n.mrf_refine(z, n)
    return -n


def _jax_mrf_choice(depth: np.ndarray) -> np.ndarray:
    """`np.argmin` over the JAX tool's MRF costs (`mrf_refine`'s own construction)."""
    z = np.asarray(depth, np.float64)
    lap_hor = np.abs(jd2n._shift(z, 0, -1) + jd2n._shift(z, 0, 1) - 2 * z)
    lap_ver = np.abs(jd2n._shift(z, -1, 0) + jd2n._shift(z, 1, 0) - 2 * z)
    cost = np.stack([jd2n._border_inf(lap_hor, 0, -1), jd2n._border_inf(lap_hor, 0, 1),
                     jd2n._border_inf(lap_ver, -1, 0), jd2n._border_inf(lap_ver, 1, 0), (lap_hor + lap_ver) / 2.0])
    return np.argmin(cost, axis=0)


@pytest.mark.parametrize("version", ["basic", "v2", "v3"])
@pytest.mark.parametrize("case", list(DEPTHS))
def test_d2nt_matches_jax(case, version):
    depth = DEPTHS[case]
    got = td2n.depth_to_normal64(depth, *INTRINSICS, version, device="cpu").numpy()
    assert got.dtype == np.float64 and got.shape == (*depth.shape, 3)
    assert np.abs(got - _jax_normals64(depth, version)).max() <= 1e-9
    got32 = td2n.depth_to_normal(depth, *INTRINSICS, version, device="cpu").numpy()
    np.testing.assert_array_equal(got32, jd2n.depth_to_normal(depth, *INTRINSICS, version))


@pytest.mark.parametrize("case", list(DEPTHS))
def test_mrf_choice_is_the_first_minimum(case):
    """Equal to `np.argmin` everywhere; on the plane every in-frame cost is
    0, and each pixel takes its first candidate in frame (the slope ties
    likewise away from the reflected border)."""
    depth = DEPTHS[case]
    got = td2n.mrf_choice(torch.from_numpy(depth)).numpy()
    want = _jax_mrf_choice(depth)
    np.testing.assert_array_equal(got, want)
    if case == "plane":
        assert (got[:, 1:] == 0).all() and (got[:, 0] == 1).all()
    if case == "slope":
        assert (got[1:-1, 2:-1] == 0).all()


def test_normal_png16_round_trip(tmp_path):
    normal = jd2n.depth_to_normal(DEPTHS["step"], *INTRINSICS, "v3")
    port, ref = str(tmp_path / "port.png"), str(tmp_path / "cv2.png")
    td2n.save_normal_png16(port, torch.from_numpy(normal))
    jd2n.save_normal_png16(ref, normal)
    want = cv2.cvtColor(cv2.imread(ref, cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)
    assert want.dtype == np.uint16
    np.testing.assert_array_equal(image_io.read_image(port), want)  # RGB on disk, as cv2 left it
    np.testing.assert_array_equal(image_io.read_image(ref), want)
    np.testing.assert_array_equal(td2n.load_normal_png16(port), jd2n.load_normal_png16(ref))
    np.testing.assert_array_equal(jd2n.load_normal_png16(port), td2n.load_normal_png16(ref))


def _hdr_frame(rng, hw, index: int):
    h, w = hw
    rgb = rng.gamma(2.0, 0.5 + index, (h, w, 3)).astype(np.float32)
    distance = rng.uniform(0.5, 40.0, (h, w)).astype(np.float32)
    distance[0, :3] = np.nan  # no hit: 0 mm in both packages
    distance[1, :3] = 90.0  # beyond 65.535 m: saturates
    entity = rng.integers(-1, 20, (h, w)).astype(np.int32)
    return rgb, distance, entity


@pytest.mark.parametrize("kind", ["frame", "dark", "all_invalid", "no_mask"])
def test_hypersim_frame_matches_jax(kind):
    rgb, distance, entity = _hdr_frame(np.random.default_rng(1), (48, 64), 0)
    if kind == "dark":
        rgb = rgb * 1e-6  # the 90th percentile below 1e-4: scale 0, a black frame
    if kind == "all_invalid":
        entity = np.full_like(entity, -1)  # nothing valid: scale 1
    if kind == "no_mask":
        entity = None
    with np.errstate(invalid="ignore"):
        want = jhp.preprocess_frame(rgb, distance, entity)
    got = thp.preprocess_frame(rgb, distance, entity, device="cpu")
    assert {k: v.dtype for k, v in got.items()} == {k: v.dtype for k, v in want.items()}
    assert np.abs(got["rgb"].astype(int) - want["rgb"]).max() <= 1
    assert np.abs(got["depth_mm"].astype(int) - want["depth_mm"]).max() <= 1
    np.testing.assert_allclose(got["depth_m"], want["depth_m"], rtol=1e-6, atol=0)
    valid = None if entity is None else entity != -1
    np.testing.assert_allclose(thp.tone_map(rgb, valid, device="cpu").numpy(), jhp.tone_map(rgb, valid),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(thp.dist_to_depth(distance, device="cpu").numpy(), jhp.dist_to_depth(distance),
                               rtol=1e-6, atol=0)
    if kind == "dark":
        assert (got["rgb"] == 0).all()


def _write_hypersim_raw(root, rng, scenes=3, frames=3, hw=(48, 64)):
    import h5py

    for s in range(scenes):
        scene = root / f"ai_00{s + 1}_001"
        color = scene / "images" / "scene_cam_00_final_hdf5"
        geom = scene / "images" / "scene_cam_00_geometry_hdf5"
        color.mkdir(parents=True)
        geom.mkdir(parents=True)
        for i in range(frames):
            rgb, distance, entity = _hdr_frame(rng, hw, i)
            for path, array in ((color / f"frame.{i:04d}.color.hdf5", rgb),
                                (geom / f"frame.{i:04d}.depth_meters.hdf5", distance),
                                (geom / f"frame.{i:04d}.render_entity_id.hdf5", entity)):
                with h5py.File(path, "w") as f:
                    f.create_dataset("dataset", data=array)
    (root / "not_a_scene.txt").write_text("skipped")


def _write_hypersim_normals(out, csv_path, rng):
    """The `geometry_preview` normal PNGs the reader takes beside `train/` (8-bit, PIL)."""
    for row in pd.read_csv(csv_path).itertuples():
        d = out / "normals" / row.scene_name / "images" / f"scene_{row.camera_name}_geometry_preview"
        d.mkdir(parents=True, exist_ok=True)
        h, w = image_io.read_image(str(out / "train" / row.rgb_path)).shape[:2]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            d / f"frame.{row.frame_id:04d}.normal_cam.png")


def _write_vkitti(root, rng, frames=2):
    leaf = os.path.join("Scene01", "fog", "frames")
    rgb_dir = root / "vkitti_2.0.3_rgb" / leaf / "rgb" / "Camera_1"
    depth_dir = root / "vkitti_2.0.3_depth" / leaf / "depth" / "Camera_1"
    rgb_dir.mkdir(parents=True)
    depth_dir.mkdir(parents=True)
    v, u = np.mgrid[0 : VKITTI_HW[0], 0 : VKITTI_HW[1]]
    for i in range(frames):
        depth = np.where(v > 190, 725.0 * 160.0 / np.maximum(v - 187, 1), 65535.0)
        depth[200:300, 300 + 100 * i : 500 + 100 * i] = 1100.0 + i  # a box: depth steps at its edges
        depth = depth + rng.integers(0, 3, VKITTI_HW)
        Image.fromarray(rng.integers(0, 256, (*VKITTI_HW, 3), dtype=np.uint8)).save(rgb_dir / f"rgb_{i:05d}.jpg")
        cv2.imwrite(str(depth_dir / f"depth_{i:05d}.png"), np.clip(depth, 1, 65535).astype(np.uint16))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Raw Hypersim (h5py) and VKITTI2 trees, each prepared by the JAX CLI /
    tool and by the port's CLIs on the CPU; a tiny checkpoint."""
    root = tmp_path_factory.mktemp("e2")
    rng = np.random.default_rng(5)
    raw = root / "hypersim_raw"
    _write_hypersim_raw(raw, rng)
    jpre_cli.main(["--hypersim_raw_dir", str(raw), "--output_dir", str(root / "hypersim_jax")])
    port_csv = preprocess_hypersim.main(["--hypersim_raw_dir", str(raw), "--output_dir", str(root / "hypersim"),
                                         "--device", "cpu"])
    _write_hypersim_normals(root / "hypersim", port_csv, np.random.default_rng(6))
    _write_vkitti(root / "vkitti_jax", rng)
    shutil.copytree(root / "vkitti_jax", root / "vkitti")
    assert jd2n.generate_vkitti_normals(str(root / "vkitti_jax"), progress=False) == 2
    assert gen_vkitti_normals.main(["--vkitti_root", str(root / "vkitti"), "--device", "cpu"]) == 2
    # the UNet attends at its second level only, so the CPU never runs plain attention over a 352x1216
    # frame's 6688 latent tokens
    ckpt = write_tiny_checkpoint(root / "ckpt", block_out_channels=(32, 64), cross_attention_levels=(False, True),
                                 num_attention_heads=(2, 2), layers_per_block=1)
    return {"root": root, "port_csv": port_csv, "ckpt": ckpt}


def test_preprocess_hypersim_matches_the_jax_cli(trees):
    root = trees["root"]
    csv_name = os.path.join("processed", "train", "filename_meta_train.csv")
    with open(root / "hypersim_jax" / csv_name, "rb") as f, open(trees["port_csv"], "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and want.count(b"\n") == 10  # a header and nine frames (three scenes)
    for row in pd.read_csv(trees["port_csv"]).itertuples():
        for rel, bound in ((row.rgb_path, 1), (row.depth_path, 1)):
            ref = np.asarray(Image.open(root / "hypersim_jax" / "train" / rel)).astype(int)
            port = image_io.read_image(str(root / "hypersim" / "train" / rel))
            assert port.dtype == (np.uint8 if "rgb" in rel else np.uint16) and port.shape == ref.shape
            assert np.abs(port.astype(int) - ref).max() <= bound, rel


def test_write_csv_matches_pandas(tmp_path):
    rows = [{"a": "x,y", "b": True, "c": 3}, {"a": 'q"r', "b": False, "c": -1}]
    for name, table in (("rows", rows), ("empty", [])):
        pd.DataFrame(table).to_csv(tmp_path / f"{name}_pd.csv", index=False)
        preprocess_hypersim.write_csv(str(tmp_path / f"{name}_port.csv"), table)
        assert (tmp_path / f"{name}_port.csv").read_bytes() == (tmp_path / f"{name}_pd.csv").read_bytes()


def test_gen_vkitti_normals_matches_the_jax_tool(trees):
    root = trees["root"]
    port = sorted(os.path.relpath(os.path.join(d, f), root / "vkitti")
                  for d, _, fs in os.walk(root / "vkitti" / "vkitti_DAG_normals") for f in fs)
    ref = sorted(os.path.relpath(os.path.join(d, f), root / "vkitti_jax")
                 for d, _, fs in os.walk(root / "vkitti_jax" / "vkitti_DAG_normals") for f in fs)
    assert port == ref and len(port) == 2
    for rel in port:
        want = cv2.cvtColor(cv2.imread(str(root / "vkitti_jax" / rel), cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(image_io.read_image(str(root / "vkitti" / rel)), want)


def _samples(reader, n):
    return [reader[i] for i in range(n)]


def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("csv_from", ["port", "pandas"])
def test_hypersim_reader_matches_jax(trees, csv_from):
    """The reader on the port's tree, its CSV written by the port or by pandas
    (the JAX CLI's `to_csv`), against the JAX reader (pandas, PIL) with the same seed."""
    root = trees["root"] / "hypersim"
    csv = trees["port_csv"]
    if csv_from == "pandas":
        csv = str(trees["root"] / "pandas.csv")
        pd.read_csv(trees["port_csv"]).to_csv(csv, index=False)
    got = ttd.Hypersim(str(root), split_csv=csv, seed=4)
    want = jtd.Hypersim(str(root), split_csv=csv, seed=4)
    assert [vars(p) for p in got.pairs] == [vars(p) for p in want.pairs] and len(got) == 9
    _assert_samples_equal(_samples(got, 9), _samples(want, 9))


def test_csv_cells_are_typed_as_pandas_types_them(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("name,flag,id,mixed,gap\na,True,3,1,\nb,false,0004,x,2\n")
    got = ttd.read_csv_rows(str(path))
    want = pd.read_csv(path).to_dict("records")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            want_cell = w[key].item() if isinstance(w[key], np.generic) else w[key]
            if isinstance(want_cell, float) and np.isnan(want_cell):
                assert np.isnan(g[key]), key
            else:
                assert (g[key], type(g[key])) == (want_cell, type(want_cell)), key


def test_vkitti_reader_matches_jax(trees):
    """The port's normals (16-bit RGB, read by the JAX reader through PIL's
    high byte) and the 16-bit depth without cv2, against the JAX reader."""
    root = str(trees["root"] / "vkitti")
    got, want = ttd.VirtualKITTI2(root, seed=2), jtd.VirtualKITTI2(root, seed=2)
    assert got.pairs == want.pairs and len(got) == 2
    normal = got.pairs[0][2]
    assert image_io.read_image(normal).dtype == np.uint16
    np.testing.assert_array_equal(ttd.read_rgb8(normal), np.asarray(Image.open(normal).convert("RGB")))
    _assert_samples_equal(_samples(got, 2), _samples(want, 2))


def test_readers_import_neither_pandas_nor_cv2(trees):
    """`Hypersim` and `VirtualKITTI2` read the port's trees in a process where
    pandas and cv2 cannot be imported."""
    import subprocess

    root = trees["root"]
    code = (
        "import sys\n"
        "for name in ('pandas', 'cv2', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "from diffusion_e2e_ft_tpu_torch.data.train_datasets import Hypersim, VirtualKITTI2\n"
        f"h = Hypersim({str(root / 'hypersim')!r}, split_csv={trees['port_csv']!r})\n"
        f"v = VirtualKITTI2({str(root / 'vkitti')!r})\n"
        "assert len(h) == 9 and len(v) == 2\n"
        "h[0], v[0]\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("source", ["tar", "dir"])
def test_make_splits_matches_jax(tmp_path, source):
    import tarfile

    names = ["a/rgb_0001.png", "a/depth_0001.png", "a/filled_0001.png", "a/rgb_0002.png", "a/depth_0002.png",
             "b/rgb_0003.png"]
    tree = tmp_path / "tree"
    for n in names:
        (tree / n).parent.mkdir(parents=True, exist_ok=True)
        (tree / n).write_bytes(b"x")
    path = tree
    if source == "tar":
        path = tmp_path / "t.tar"
        with tarfile.open(path, "w") as tar:
            tar.add(tree, arcname=".")
    got = tsplits.build_split("nyu_v2", str(path))
    assert got == jsplits.build_split("nyu_v2", str(path)) and len(got) == 2
    n = tsplits.write_split("nyu_v2", str(path), str(tmp_path / "out.txt"))
    assert n == 2 and (tmp_path / "out.txt").read_text().splitlines() == got


def test_cli_train_normals_on_the_ports_trees(trees, tmp_path):
    """Two steps of the tiny model at batch 1 on the trees the port's CLIs
    wrote, on the CPU: a Hypersim batch at 480x640 and the VKITTI2 batch at
    352x1216. Nine Hypersim frames and two VKITTI2 ones make a 9:1 epoch of
    ten batches; the seed is the first whose shuffled schedule puts the
    VKITTI2 batch among the first two."""
    from diffusion_e2e_ft_tpu_torch.data.mixer import MixedLoader
    from diffusion_e2e_ft_tpu_torch.training import checkpoints as C
    from diffusion_e2e_ft_tpu_torch.training.trainer import E2ETrainer

    root = trees["root"]
    seed = next(s for s in range(100) if not MixedLoader(range(9), range(2), 9, 1, seed=s).schedule()[:2].all())
    shapes, step = [], E2ETrainer.train_step

    def recording_step(self, state, batch, generator=None):
        shapes.append(batch["rgb"].shape)
        return step(self, state, batch, generator)

    E2ETrainer.train_step = recording_step
    try:
        train_cli.main([
            "--pretrained_model_name_or_path", trees["ckpt"], "--modality", "normals",
            "--output_dir", str(tmp_path / "run"), "--hypersim_root", str(root / "hypersim"),
            "--hypersim_split_csv", trees["port_csv"], "--vkitti_root", str(root / "vkitti"),
            "--train_batch_size", "1", "--gradient_accumulation_steps", "1", "--max_train_steps", "2",
            "--checkpointing_steps", "100", "--lr_warmup_steps", "0", "--seed", str(seed), "--device", "cpu",
        ])
    finally:
        E2ETrainer.train_step = step
    assert sorted(s[:3] for s in shapes) == [(1, 352, 1216), (1, 480, 640)]
    assert C.list_checkpoints(str(tmp_path / "run")) == []
    assert os.path.isfile(tmp_path / "run" / "export" / "unet" / "config.json")


@pytest.mark.parametrize("entry", ["gen_vkitti_normals", "preprocess_hypersim", "train"])
def test_entry_points_default_to_cuda(trees, tmp_path, entry):
    """Without `--device` the CLIs run on the card: on this machine, which has
    none, they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("with a card the default device is that card; this checks the refusal without one")
    root = trees["root"]
    argv = {
        "gen_vkitti_normals": (gen_vkitti_normals.main, ["--vkitti_root", str(root / "vkitti")]),
        "preprocess_hypersim": (preprocess_hypersim.main, ["--hypersim_raw_dir", str(root / "hypersim_raw"),
                                                           "--output_dir", str(tmp_path / "out")]),
        "train": (train_cli.main, ["--pretrained_model_name_or_path", trees["ckpt"], "--output_dir",
                                   str(tmp_path / "run"), "--hypersim_root", str(root / "hypersim"),
                                   "--hypersim_split_csv", trees["port_csv"], "--vkitti_root", str(root / "vkitti")]),
    }
    main, args = argv[entry]
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        main(args)


def _script_command(path) -> list:
    """The `python -m <module> <args>` words of a training script."""
    with open(path) as f:
        text = f.read()
    return shlex.split(text[text.index("python -m"):].replace("\\\n", " "))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPTS = sorted(f for f in os.listdir(os.path.join(REPO, "scripts")) if f.startswith("train_"))


@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_torch_train_scripts_match_the_jax_scripts(name):
    """`scripts/torch_<name>` runs the port's CLI with the JAX script's flags, which its parser takes."""
    jax_cmd = _script_command(os.path.join(REPO, "scripts", name))
    port_cmd = _script_command(os.path.join(REPO, "scripts", "torch_" + name))
    assert jax_cmd[:3] == ["python", "-m", "diffusion_e2e_ft_tpu.cli.train"]
    assert port_cmd[:3] == ["python", "-m", "diffusion_e2e_ft_tpu_torch.cli.train"]
    assert port_cmd[3:] == jax_cmd[3:]
    args = train_cli.build_parser().parse_args(port_cmd[3:])
    assert args.device == "cuda" and args.gradient_checkpointing


def test_prepare_data_script(tmp_path):
    """`scripts/torch_prepare_data.sh` with DEVICE=cpu: the Hypersim PNG pairs
    and CSV, the preview normals linked where the reader looks, the VKITTI2 normals."""
    import subprocess

    rng = np.random.default_rng(8)
    raw, out, vkitti = tmp_path / "raw", tmp_path / "hypersim", tmp_path / "vkitti"
    _write_hypersim_raw(raw, rng, scenes=1, frames=1)
    preview = raw / "ai_001_001" / "images" / "scene_cam_00_geometry_preview"
    preview.mkdir()
    Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(preview / "frame.0000.normal_cam.png")
    _write_vkitti(vkitti, rng, frames=1)
    env = {**os.environ, "HYPERSIM_RAW_DIR": str(raw), "HYPERSIM_ROOT": str(out), "VKITTI_ROOT": str(vkitti),
           "DEVICE": "cpu", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(["bash", os.path.join(REPO, "scripts", "torch_prepare_data.sh")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "1 frames ->" in proc.stdout and "generated normals for 1 frames" in proc.stdout
    reader = ttd.Hypersim(str(out))
    assert len(reader) == 1 and reader[0]["normals"].shape == (480, 640, 3)
    assert ttd.VirtualKITTI2(str(vkitti))[0]["normals"].shape == (352, 1216, 3)
