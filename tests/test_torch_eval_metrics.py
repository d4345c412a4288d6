"""The port's evaluation math against the JAX package's, on seeded arrays.

- The ten depth metrics and `MetricTracker`, [B, H, W] and [H, W] with a
  valid mask: 1e-5 relative (float32 sums over a few thousand pixels in
  another order; the port's are torch, the JAX package's jax.numpy).
- The normal metrics on an even count of errors: exact, so a median that
  takes the lower middle value (as `torch.median` does) shows.
- Least-squares alignment in depth and disparity, with and without
  `max_resolution`: (scale, shift) to 1e-9 (both float64 lstsq).
- The `ops/image.py` helpers (exact) and `colorize_depth`'s own Spectral
  table against matplotlib's (exact); `seed_all`.
"""

import random

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu.evaluation import alignment as jalign
from diffusion_e2e_ft_tpu.evaluation import metrics as jm
from diffusion_e2e_ft_tpu.ops import image as jim
from diffusion_e2e_ft_tpu_torch.evaluation import alignment as talign
from diffusion_e2e_ft_tpu_torch.evaluation import metrics as tm
from diffusion_e2e_ft_tpu_torch.ops import image as tim
from diffusion_e2e_ft_tpu_torch.utils.seeding import seed_all

RTOL = 1e-5


def depth_case(shape, seed=0):
    """(prediction, GT, mask): GT in (0.5, 10) m, a noisy affine prediction, ~20% invalid."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 10.0, shape).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, shape) + 0.1).astype(np.float32)
    mask = rng.random(shape) > 0.2
    gt[~mask & (rng.random(shape) > 0.5)] = 0.0  # invalid pixels may hold 0
    return pred, gt, mask


@pytest.mark.parametrize("shape", [(3, 40, 56), (40, 56)], ids=["BHW", "HW"])
@pytest.mark.parametrize("name", list(jm.DEPTH_METRIC_FUNCS))
def test_depth_metric_matches_jax(name, shape):
    pred, gt, mask = depth_case(shape)
    want = jm.DEPTH_METRIC_FUNCS[name](pred, gt, mask)
    got = tm.DEPTH_METRIC_FUNCS[name](torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask))
    assert isinstance(got, float) and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    # numpy inputs and no mask go through the same path
    np.testing.assert_allclose(tm.DEPTH_METRIC_FUNCS[name](pred + 1, gt + 1),
                               jm.DEPTH_METRIC_FUNCS[name](pred + 1, gt + 1), rtol=RTOL, atol=0)


def test_metric_tracker_matches_jax():
    keys = list(jm.DEPTH_METRIC_FUNCS)
    want, got = jm.MetricTracker(*keys), tm.MetricTracker(*keys)
    for seed in range(3):
        pred, gt, mask = depth_case((32, 48), seed)
        for name in keys:
            want.update(name, jm.DEPTH_METRIC_FUNCS[name](pred, gt, mask))
            got.update(name, tm.DEPTH_METRIC_FUNCS[name](pred, gt, mask))
    want.update("extra", 2.0, n=3)
    got.update("extra", 2.0, n=3)
    assert list(got.result()) == list(want.result())
    np.testing.assert_allclose(list(got.result().values()), list(want.result().values()), rtol=RTOL)
    got.reset()
    assert all(v == 0.0 for v in got.result().values())


def test_normal_metrics_match_jax_exactly():
    rng = np.random.default_rng(5)
    pred, gt = rng.normal(size=(2, 24, 32, 3)).astype(np.float32)
    err = tm.normal_angular_error_deg(pred, gt)
    np.testing.assert_array_equal(err, jm.normal_angular_error_deg(pred, gt))
    errors = err.reshape(-1)[:1000]  # an even count: the median averages the two middle values
    got, want = tm.normal_metrics(errors), jm.normal_metrics(errors)
    assert got == want
    assert got["median"] != float(torch.median(torch.from_numpy(errors)))


@pytest.mark.parametrize("max_res", [None, 20], ids=["full", "max_res"])
@pytest.mark.parametrize("space", ["depth", "disparity"])
def test_alignment_matches_jax(space, max_res):
    pred, gt, mask = depth_case((48, 64), seed=2)
    pred = (pred / 10.0).astype(np.float32)  # an affine-invariant prediction in about [0, 1]
    if space == "disparity":
        gt, positive = jalign.depth2disparity(gt, return_mask=True)
        tgt, tpositive = talign.depth2disparity(depth_case((48, 64), seed=2)[1], return_mask=True)
        np.testing.assert_array_equal(tgt, gt)
        mask = mask & positive
    want = jalign.align_depth_least_square(gt, pred, mask, max_resolution=max_res)
    got = talign.align_depth_least_square(gt, pred, mask, max_resolution=max_res)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_array_equal(talign.disparity2depth(got[0]), jalign.disparity2depth(got[0]))


def test_image_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 37, 45, 3)).astype(np.float32)
    np.testing.assert_allclose(tim.denormalize_rgb(torch.from_numpy(x)).numpy(),
                               np.asarray(jim.denormalize_rgb(jnp.asarray(x))), rtol=1e-6)
    for a in (x, x[0]):
        padded, hw = tim.pad_to_multiple(torch.from_numpy(a), 16)
        want, want_hw = jim.pad_to_multiple(jnp.asarray(a), 16)
        assert hw == tuple(want_hw)
        np.testing.assert_array_equal(padded.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tim.unpad(padded, hw).numpy(), np.asarray(jim.unpad(want, want_hw)))
    d = rng.uniform(0, 1, (37, 45)).astype(np.float32)
    np.testing.assert_array_equal(tim.to_uint16(d), jim.to_uint16(d))
    np.testing.assert_array_equal(tim.hwc2chw(x[0]), jim.hwc2chw(x[0]))
    np.testing.assert_array_equal(tim.chw2hwc(tim.hwc2chw(x[0])), jim.chw2hwc(jim.hwc2chw(x[0])))


def test_spectral_colormap_matches_matplotlib():
    """The port colours depth with its own copy of matplotlib's Spectral table
    (matplotlib imports PIL, which the H100 host lacks); the same float32
    values, at every lookup boundary and beyond [0, 1]."""
    x = np.concatenate([np.random.default_rng(7).uniform(-0.2, 1.2, 20000),
                        np.linspace(0, 1, 4097), [0, 1, 1 - 1e-7, 1 / 256, 255 / 256]]).astype(np.float32)
    got = tim.colorize_depth(x.reshape(2, -1))
    np.testing.assert_array_equal(got, matplotlib.colormaps["Spectral"](np.clip(x, 0, 1).reshape(2, -1))[..., :3]
                                  .astype(np.float32))
    np.testing.assert_array_equal(got, jim.colorize_depth(x.reshape(2, -1)))
    np.testing.assert_array_equal(tim.colorize_depth(x[:100], cmap="viridis"), jim.colorize_depth(x[:100], cmap="viridis"))


def test_seed_all_seeds_every_host_rng():
    gen = seed_all(3)
    a = (random.random(), np.random.random(), torch.rand(1).item(), torch.rand(1, generator=gen).item())
    gen = seed_all(3)
    assert a == (random.random(), np.random.random(), torch.rand(1).item(), torch.rand(1, generator=gen).item())
