"""The port's image IO and evaluation readers against the JAX package's.

- The numpy PNG codec (`data/image_io.py`): decoding is bit-identical to PIL
  for 8-bit gray, RGB and RGBA and 16-bit gray, for each of the five row
  filters forced one at a time and for files PIL wrote with its own adaptive
  filters; 16-bit RGB against libpng. `write_png` files read back through PIL
  unchanged. Interlaced, palette and non-PNG/JPEG files raise, naming what
  they are.
- The port's `native_io` builds here and decodes bit-identically to the JAX
  package's binding (same C source, same libpng / libjpeg).
- `cli.common.load_dataset_config` equals `yaml.safe_load` on every dataset
  config and raises on nested YAML.
- The depth reader: every field of every sample equals the JAX reader's, bit
  for bit, on synthetic trees for each of the five `SPECS` (NYU tar + eigen
  crop, KITTI + KB crop + `None` line, ETH3D raw binary, DIODE `.npy` mask,
  ScanNet tar with JPEG frames), through both of the port's PNG decoders.
- The normal reader: every field equals the JAX reader's (cv2) on an 8-bit
  (nyuv2) and a 16-bit (vkitti) PNG tree.
Tolerance: none; every comparison is exact.
"""

import io
import os
import struct
import tarfile
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

from diffusion_e2e_ft_tpu import native_io as jnative
from diffusion_e2e_ft_tpu.data import depth_eval as jde
from diffusion_e2e_ft_tpu.data import normal_eval as jne
from diffusion_e2e_ft_tpu_torch import native_io as tnative
from diffusion_e2e_ft_tpu_torch.cli.common import load_dataset_config
from diffusion_e2e_ft_tpu_torch.data import depth_eval as tde
from diffusion_e2e_ft_tpu_torch.data import image_io
from diffusion_e2e_ft_tpu_torch.data import normal_eval as tne

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {  # name: (shape, dtype)
    "gray8": ((29, 41), np.uint8),
    "rgb8": ((29, 41, 3), np.uint8),
    "rgba8": ((29, 41, 4), np.uint8),
    "gray16": ((29, 41), np.uint16),
}


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX reader decodes through its native library when it is built
    (else PIL): build it, so that both readers decode JPEG with libjpeg."""
    assert jnative.build(), "the JAX package's native IO library did not build"


def smooth_image(shape, dtype, seed=0) -> np.ndarray:
    """Gradients plus a little noise: PIL's adaptive filtering picks
    Sub / Up / Average / Paeth rows on such images."""
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    top = 65535 if dtype == np.uint16 else 255
    chans = shape[2] if len(shape) == 3 else 1
    noise = np.random.default_rng(seed).uniform(0, 0.05, (h, w, chans))
    img = np.stack([(np.sin(xx / (5 + c) + yy / 7) + 1) / 2.1 for c in range(chans)], -1) + noise
    img = (img * top).astype(dtype)
    return img[..., 0] if len(shape) == 2 else img


def pil_png(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")  # uint16 [H, W] is mode I;16
    return buf.getvalue()


def row_filters(png: bytes) -> set:
    h = struct.unpack(">I", png[20:24])[0]
    data = b"".join(d for k, d in image_io._chunks(png) if k == b"IDAT")
    return set(np.frombuffer(zlib.decompress(data), np.uint8).reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "pil"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_decode_matches_pil(kind, filter_type):
    shape, dtype = KINDS[kind]
    a = smooth_image(shape, dtype)
    png = pil_png(a) if filter_type == "pil" else image_io.encode_png(a, filter_type)
    if filter_type != "pil":
        assert row_filters(png) == {filter_type}
    want = np.asarray(Image.open(io.BytesIO(png)))
    got = image_io.decode_png_numpy(png)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, a)


def test_pil_adaptive_files_use_the_sequential_filters():
    """The adaptive case above exercises Average / Paeth rows, not only None / Sub / Up."""
    assert row_filters(pil_png(smooth_image((48, 64, 3), np.uint8))) & {3, 4}


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png16_rgb_matches_libpng(filter_type):
    a = smooth_image((23, 37, 3), np.uint16)
    png = image_io.encode_png(a, filter_type)
    np.testing.assert_array_equal(image_io.decode_png_numpy(png), tnative.decode_png(png))
    np.testing.assert_array_equal(image_io.decode_png_numpy(png), a)


@pytest.mark.parametrize("kind", list(KINDS))
def test_write_png_reads_back_through_pil(tmp_path, kind):
    shape, dtype = KINDS[kind]
    a = np.random.default_rng(1).integers(0, np.iinfo(dtype).max, shape, dtype=dtype, endpoint=True)
    path = str(tmp_path / f"{kind}.png")
    image_io.write_png(path, a)
    assert row_filters(open(path, "rb").read()) == {0}
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)


def test_unsupported_files_raise_naming_them():
    a = smooth_image((8, 8, 3), np.uint8)
    png = bytearray(image_io.encode_png(a))
    png[28] = 1  # IHDR's interlace byte
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])))
    with pytest.raises(image_io.ImageFormatError, match="interlaced"):
        image_io.decode_png_numpy(bytes(png))
    buf = io.BytesIO()
    Image.fromarray(a).convert("P").save(buf, format="PNG")
    with pytest.raises(image_io.ImageFormatError, match="palette"):
        image_io.decode_png_numpy(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="BMP")
    with pytest.raises(image_io.ImageFormatError, match="BMP"):
        image_io.decode_image(buf.getvalue())


def test_native_io_builds_and_matches_the_jax_binding():
    assert tnative.available() and tnative.build_error() is None
    assert image_io.png_decoder() == "native_io"
    assert tnative.BUILD_DIR in tnative._build().parents  # never native/ itself
    for kind, (shape, dtype) in KINDS.items():
        png = pil_png(smooth_image(shape, dtype))
        np.testing.assert_array_equal(tnative.decode_png(png), jnative.decode_png(png))
    depth = pil_png(smooth_image((31, 45), np.uint16))
    np.testing.assert_array_equal(tnative.decode_png16_depth(depth, 1000.0), jnative.decode_png16_depth(depth, 1000.0))
    buf = io.BytesIO()
    Image.fromarray(smooth_image((33, 47, 3), np.uint8)).save(buf, format="JPEG", quality=90)
    jpeg = buf.getvalue()
    np.testing.assert_array_equal(tnative.decode_jpeg(jpeg), jnative.decode_jpeg(jpeg))
    np.testing.assert_array_equal(image_io.decode_image(jpeg), jnative.decode_image(jpeg))


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "config", "dataset"))))
def test_dataset_config_reader_equals_yaml(name):
    path = os.path.join(REPO, "config", "dataset", name)
    with open(path) as f:
        assert load_dataset_config(path) == yaml.safe_load(f)


def test_dataset_config_reader_raises_on_nested(tmp_path):
    flat = tmp_path / "flat.yaml"
    flat.write_text("# comment\nname: x  # trailing\nn: 3\nf: 1.5e-3\nb: true\nq: 'a: b'\nnone:\n")
    assert load_dataset_config(str(flat)) == yaml.safe_load(flat.read_text())
    for text in ("a:\n  b: 1\n", "a:\n- 1\n", "a: [1, 2]\n", "a: {b: 1}\n"):
        bad = tmp_path / "bad.yaml"
        bad.write_text(text)
        with pytest.raises(ValueError):
            load_dataset_config(str(bad))


# ---------------------------------------------------------------------------
# depth readers
# ---------------------------------------------------------------------------


def _tar(path: str, members: dict) -> str:
    with tarfile.open(path, "w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo("./" + name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def _jpeg(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def make_depth_tree(root, name: str):
    """(dataset path, filename list) of a two-frame synthetic tree in `name`'s layout."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    members, lines = {}, []
    if name == "nyu_v2":  # tar; PNG rgb, depth and filled depth in mm; 480x640 for the eigen crop
        for i in range(2):
            members[f"test/s/rgb_{i:04d}.png"] = pil_png(smooth_image((480, 640, 3), np.uint8, i))
            depth = rng.integers(0, 11000, (480, 640)).astype(np.uint16)
            members[f"test/s/depth_{i:04d}.png"] = image_io.encode_png(depth, 4)
            members[f"test/s/filled_{i:04d}.png"] = pil_png(np.maximum(depth, 500))
            lines.append(f"test/s/rgb_{i:04d}.png test/s/depth_{i:04d}.png test/s/filled_{i:04d}.png")
    elif name == "kitti":  # tar; 375x1242 frames (KB crop), depth x 256, one frame without GT
        for i in range(2):
            members[f"d/image_02/{i:010d}.png"] = pil_png(smooth_image((375, 1242, 3), np.uint8, i))
            depth = rng.integers(0, 90 * 256, (375, 1242)).astype(np.uint16)
            members[f"gt/{i:010d}.png"] = pil_png(depth)
            lines.append(f"d/image_02/{i:010d}.png gt/{i:010d}.png 721.5377")
        lines.insert(1, "d/image_02/0000000009.png None 721.5377")
    elif name == "eth3d":  # directory; JPEG rgb, raw float32 depth at 4032x6048 with inf holes
        for i in range(2):
            members[f"rgb/{i}.JPG"] = _jpeg(smooth_image((40, 60, 3), np.uint8, i))
            depth = rng.uniform(0, 30, (4032, 6048)).astype(np.float32)
            depth[::97, ::89] = np.inf
            members[f"depth/{i}.JPG"] = depth.tobytes()
            lines.append(f"rgb/{i}.JPG depth/{i}.JPG")
    elif name == "diode":  # directory; PNG rgb, npy depth [H, W, 1] and npy mask
        for i in range(2):
            members[f"in/{i}.png"] = pil_png(smooth_image((48, 64, 3), np.uint8, i))
            members[f"in/{i}_depth.npy"] = _npy(rng.uniform(0.1, 400, (48, 64, 1)).astype(np.float32))
            members[f"in/{i}_depth_mask.npy"] = _npy(rng.random((48, 64)) > 0.3)
            lines.append(f"in/{i}.png in/{i}_depth.npy in/{i}_depth_mask.npy")
    else:  # scannet: tar; JPEG rgb, 16-bit depth in mm
        for i in range(2):
            members[f"scene0/color/{i:06d}.jpg"] = _jpeg(smooth_image((48, 64, 3), np.uint8, i))
            members[f"scene0/depth/{i:06d}.png"] = pil_png(rng.integers(0, 12000, (48, 64)).astype(np.uint16))
            lines.append(f"scene0/color/{i:06d}.jpg scene0/depth/{i:06d}.png")
    list_path = os.path.join(root, f"{name}.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if name in ("nyu_v2", "kitti", "scannet"):
        return _tar(os.path.join(root, f"{name}.tar"), members), list_path
    data = os.path.join(root, name)
    for rel, blob in members.items():
        os.makedirs(os.path.dirname(os.path.join(data, rel)), exist_ok=True)
        with open(os.path.join(data, rel), "wb") as f:
            f.write(blob)
    return data, list_path


def assert_same_sample(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("name", sorted(jde.SPECS))
def test_depth_reader_matches_jax(tmp_path, name):
    path, list_path = make_depth_tree(str(tmp_path), name)
    for mode in (jde.DatasetMode.EVAL, jde.DatasetMode.RGB_ONLY):
        want = jde.DepthEvalDataset(jde.SPECS[name], path, list_path, mode)
        got = tde.DepthEvalDataset(tde.SPECS[name], path, list_path, tde.DatasetMode(mode.value))
        assert got.filenames == want.filenames and len(got) == len(want) == 2
        assert got.decoder == "native_io"
        samples = [want[i] for i in range(len(want))]
        for i, sample in enumerate(samples):
            assert_same_sample(got[i], sample)
            assert got.pred_name(i) == want.pred_name(i)
        got.decoder = "numpy"  # a host where native_io did not build
        assert_same_sample(got[0], samples[0])
        if mode == jde.DatasetMode.EVAL:
            mask = samples[0]["valid_mask_raw"]
            assert mask.any() and not mask.all()
    if name == "nyu_v2":  # the eigen crop
        assert not mask[:45].any() and not mask[:, 601:].any() and mask[45:471, 41:601].any()
    if name == "kitti":  # the KB crop
        assert samples[0]["rgb_int"].shape == (352, 1216, 3)


def test_get_depth_dataset_reads_the_config(tmp_path):
    path, list_path = make_depth_tree(str(tmp_path), "scannet")
    cfg = {"name": "scannet", "dir": os.path.basename(path), "filenames": list_path}
    ds = tde.get_depth_dataset(cfg, str(tmp_path), tde.DatasetMode.EVAL)
    assert ds.is_tar and len(ds) == 2 and ds.pred_name(1) == "pred_000001.npy"
    with pytest.raises(ValueError, match="Unknown dataset"):
        tde.get_depth_dataset({**cfg, "name": "nyu"}, str(tmp_path))


# ---------------------------------------------------------------------------
# normal readers
# ---------------------------------------------------------------------------


def make_normal_tree(base, name: str, depth16: bool) -> str:
    root = os.path.join(base, "dsine_eval", name)
    os.makedirs(os.path.join(root, "scene0"))
    rng = np.random.default_rng(4)
    lines = []
    for i in range(2):
        stem = os.path.join(root, "scene0", f"{i:04d}")
        Image.fromarray(smooth_image((48, 64, 3), np.uint8, i)).save(stem + "_img.png")
        n = rng.normal(size=(48, 64, 3))
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        top = 65535 if depth16 else 255
        raw = ((n + 1) / 2 * top).astype(np.uint16 if depth16 else np.uint8)
        raw[:3, :5] = 0  # invalid pixels
        image_io.write_png(stem + "_normal.png", raw, filter_type=4)
        np.save(stem + "_intrins.npy", np.eye(3) * (i + 1))
        lines.append(f"scene0/{i:04d}_img.png")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(root, "test.txt")


@pytest.mark.parametrize("name", ["nyuv2", "vkitti"])
def test_normal_reader_matches_jax(tmp_path, name):
    split = make_normal_tree(str(tmp_path), name, depth16=name == "vkitti")
    want = jne.get_normal_dataset(name, str(tmp_path), split)
    got = tne.get_normal_dataset(name, str(tmp_path), split)
    assert got.sample_paths == want.sample_paths
    for i in range(len(want)):
        a, b = got[i], want[i]
        for field in ("img", "normal", "normal_mask", "intrins"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
        assert (a.dataset_name, a.scene_name, a.img_name) == (b.dataset_name, b.scene_name, b.img_name)
        assert not a.normal_mask[:3, :5].any()
