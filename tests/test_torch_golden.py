"""The port held to the JAX package's committed golden outputs
(`tests/golden/*.npz`, written by `tests/golden/make_goldens.py`), on the
CPU in fp32, without importing JAX: a box without JAX runs these tests
(`test_goldens_hold_without_jax` runs them so, with `--noconftest`).

Every Tier-1 golden: the port's modules are built from the golden's configs,
their key sets and shapes must be the JAX modules' (the golden records
them), they are filled by the weight rule of `tests/_torch_golden.py`, whose
digest must match the file's, then the port runs on the stored inputs. Each
output's bound is in `tests/_torch_golden_port.py::BOUNDS`, beside the
existing parity test it comes from: the device bodies 1e-4 (Marigold's
normals 1e-3, its three-step normal members 5e-3), `combine_depths` 1e-5,
the train steps' loss, per-loss metrics and grad norm 1e-5 relative and
their updated parameters' per-leaf sums within what 1e-6 an element allows,
the depth metrics 1e-5 relative, the alignments' (scale, shift) 1e-9, the
normal metrics and D2NT to the bit, the Hypersim frame within one level.
`test_regenerated_goldens_match_the_committed_files` (JAX) rebuilds two of
the files and holds them to the committed ones within 1e-6 of max |value|.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_golden as R
import _torch_golden_port as P

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TIER1 = ["marigold_single", "marigold_multi", "geowizard", "train_sd2", "train_geowizard", "eval_metrics",
         "data_prep"]
CARD = ["card_marigold", "card_geowizard", "card_train"]
SIZE_CAP = 8 << 20  # bytes, every golden file together
REGEN_RTOL = 1e-6  # a rebuilt golden against the committed one, of max |value|


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops: under the suite's parallel workers a thread pool per op
    costs more than it gives, so this module runs on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def goldens():
    return {name: R.Golden(name) for name in TIER1 + CARD}


def run_port(g):
    """The port's outputs for a Tier-1 golden, on the CPU."""
    name = g.name
    if name == "marigold_single":
        return P.single_step(g, P.marigold_pipeline(g, P.modules(g)), ("_64", "_72x56"))
    if name == "marigold_multi":
        return P.marigold_multi(g, P.modules(g))
    if name == "geowizard":
        return P.geowizard(g, P.geowizard_pipeline(P.modules(g)))
    if name == "train_sd2":
        return {k: v for m in g.meta["modalities"] for k, v in P.train_step(g, P.modules(g), f"{m}.", modality=m).items()}
    if name == "train_geowizard":
        return P.train_step(g, P.modules(g), "")
    if name == "eval_metrics":
        return P.eval_metrics(g)
    return P.data_prep(g)


@pytest.mark.parametrize("name", TIER1)
def test_port_matches_golden(goldens, name):
    g = goldens[name]
    rows = P.compare(g, run_port(g), P.BOUNDS[name])
    assert len(rows) == len(P.BOUNDS[name]) and all(row.ok for row in rows), "\n".join(map(str, rows))


def test_rule_draws_by_kind():
    """Sorted key order whatever the mapping's order; each kind's scale."""
    shapes = {"b.weight": (64, 32, 3, 3), "a.bias": (64,), "norm.weight": (4096,), "c.weight": (128, 512),
              "embeddings.position_embedding.weight": (257, 64), "embeddings.class_embedding": (64,)}
    w = R.golden_weights(shapes, 5)
    again = R.golden_weights(dict(reversed(list(shapes.items()))), 5)
    assert all(np.array_equal(w[k], again[k]) and w[k].dtype == np.float32 for k in shapes)
    np.testing.assert_allclose(w["b.weight"].std(), 1 / np.sqrt(32 * 9), rtol=0.05)
    np.testing.assert_allclose(w["c.weight"].std(), 1 / np.sqrt(512), rtol=0.05)
    np.testing.assert_allclose(w["norm.weight"].mean(), 1.0, atol=0.01)
    np.testing.assert_allclose(w["norm.weight"].std(), 0.1, rtol=0.05)
    np.testing.assert_allclose(w["embeddings.position_embedding.weight"].std(), 0.02, rtol=0.05)
    assert np.abs(w["embeddings.class_embedding"]).max() < 0.1 and np.abs(w["a.bias"]).max() < 0.6
    assert {k: R.weight_kind(k, len(s)) for k, s in shapes.items()} == {
        "b.weight": "matrix", "a.bias": "bias", "norm.weight": "norm", "c.weight": "matrix",
        "embeddings.position_embedding.weight": "embedding", "embeddings.class_embedding": "embedding"}


def test_digest_names_another_stream():
    shapes = {"w": (16, 8), "b": (16,)}
    want = R.digest(R.golden_weights(shapes, 1))
    R.check_digest("probe", "unet", R.digest({k: torch.from_numpy(v) for k, v in R.golden_weights(shapes, 1).items()}),
                   want)
    with pytest.raises(AssertionError, match="weight stream differs"):
        R.check_digest("probe", "unet", R.digest(R.golden_weights(shapes, 2)), want)


@pytest.mark.parametrize("name", TIER1 + CARD)
def test_golden_file_carries_meta_digest_inputs_outputs(goldens, name):
    g = goldens[name]
    assert g.meta["name"] == name and g.meta["numpy"] and g.meta["path"] and g.meta["input_seeds"]
    assert g.meta["image_hw"] or not g.meta["weights"]  # every model golden records its image size
    assert set(g.digests) == set(g.meta["weights"])
    for part, spec in g.meta["weights"].items():
        assert isinstance(spec["seed"], int) and len(g.digests[part]) == len(spec["shapes"]) > 0
        assert g.meta["reduced"]
    assert set(P.BOUNDS[name]) <= set(g.arrays)
    assert all(np.isfinite(g[k]).all() for k in P.BOUNDS[name] if not k.startswith("hypersim"))


@pytest.mark.parametrize("name", TIER1 + CARD)
def test_port_key_sets_match_the_jax_modules(goldens, name):
    """The port's state_dict keys and shapes, from its own modules, are the
    JAX module's that the golden recorded (meta device: no weights)."""
    g = goldens[name]
    for part in g.meta["weights"]:
        assert P.key_shapes(P.new_module(part, g.meta[part])) == g.shapes(part), part


@pytest.mark.parametrize("name", TIER1 + CARD)
def test_depth_goldens_are_not_saturated(goldens, name):
    g = goldens[name]
    for key, share in g.meta["inside"].items():
        assert share == R.inside_share(g[key]) >= R.MIN_INSIDE, key


def test_goldens_fit_the_size_cap():
    files = [f for f in os.listdir(R.GOLDEN_DIR) if f.endswith(".npz")]
    assert sorted(f[:-4] for f in files) == sorted(TIER1 + CARD)
    assert sum(os.path.getsize(os.path.join(R.GOLDEN_DIR, f)) for f in files) <= SIZE_CAP


def test_goldens_hold_without_jax():
    """This file's port tests again in a process where JAX, its libraries and
    the JAX package cannot be imported, without tests/conftest.py."""
    from test_torch_import import JAX_BLOCKER

    code = (JAX_BLOCKER + "import pytest\n"
            f"rc = pytest.main([{__file__!r}, '-q', '--noconftest', '-p', 'no:cacheprovider', '-p', 'no:randomly', "
            "'-k', 'not regenerated and not without_jax'])\n"
            "assert not any(m == 'diffusion_e2e_ft_tpu' or m.startswith('diffusion_e2e_ft_tpu.') or m == 'jax' "
            "for m in sys.modules if sys.modules[m] is not None), 'JAX was imported'\n"
            "sys.exit(int(rc))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([TESTS, REPO])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    ran = len(TIER1) + 3 * len(TIER1 + CARD) + 3  # every test of this file but the two deselected
    assert f"\n{ran} passed, 2 deselected" in proc.stdout, proc.stdout[-2000:]


def test_regenerated_goldens_match_the_committed_files():
    """The two cheapest Tier-1 goldens, rebuilt by the generator with JAX
    (Marigold single step at 64x64, the SD2 depth train step), equal the
    committed files within 1e-6 of each array's max |value|."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_goldens", os.path.join(R.GOLDEN_DIR, "make_goldens.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    for name, kw in (("marigold_single", {"sizes": ("64",)}), ("train_sd2", {"modalities": ("depth",)})):
        meta, digests, arrays = gen.build(name, **kw)
        committed = R.Golden(name)
        assert meta["weights"] == committed.meta["weights"]
        for part, d in digests.items():
            np.testing.assert_array_equal(d, committed.digests[part])
        assert arrays and set(arrays) <= set(committed.arrays)
        for key, value in arrays.items():
            want = committed[key]
            assert value.shape == want.shape, key
            scale = float(np.abs(want).max()) if want.size else 0.0
            np.testing.assert_allclose(np.asarray(value, np.float64), want, rtol=0, atol=REGEN_RTOL * scale,
                                       err_msg=f"{name}/{key}")
