"""Slice E2's helper modules against the JAX package's, on the CPU, and two
checks of the trainer and the ensemble that slice E2's path leans on.

- `utils/geometry.py`: intrinsics, rays, rotations, the cv2 warp and the
  renderings equal the JAX package's (the same numpy; `depth_to_rgb` through
  the port's own Spectral table against matplotlib's): exact.
- `data/augmentations.py`: each transform, and the benchmark and training
  pipelines, on the same sample with a Generator from the same seed: exact.
- `ops/depth_transform.NearFarMetricNormalizer` (torch) against the JAX
  package's numpy: 1e-6 (float32 quantiles, another summation order).
- `training/normal_losses.py`, the four losses and `LOSS_FUNCS`: 1e-5
  relative (float32 sums in another order).
- One train step of the tiny config at 22x76, whose 11x38 latent is odd at
  the UNet's first level (as 352x1216's 44x152 latent is at SD2's third):
  the up path's `upsample_hw` branch through the backward, loss and every
  gradient leaf within the train-parity bounds of
  `tests/test_torch_train_step.py`.
- The depth ensemble's BFGS in both packages: x0 is the same float32
  vector; scipy's finite-difference step (2**-26 = 1.49e-8) vanishes when x
  is cast to float32 at every |x| >= 0.5, and on [0.25, 0.5) where x's
  significand is even (it is exactly half an ulp there, rounded to even);
  wherever it vanishes each closure returns its objective at x0 unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from diffusion_e2e_ft_tpu.data import augmentations as jaug
from diffusion_e2e_ft_tpu.ops import depth_transform as jdt
from diffusion_e2e_ft_tpu.ops import ensemble as jens
from diffusion_e2e_ft_tpu.training import normal_losses as jnl
from diffusion_e2e_ft_tpu.utils import geometry as jgeo
from diffusion_e2e_ft_tpu_torch.data import augmentations as taug
from diffusion_e2e_ft_tpu_torch.ops import depth_transform as tdt
from diffusion_e2e_ft_tpu_torch.ops import ensemble as tens
from diffusion_e2e_ft_tpu_torch.training import normal_losses as tnl
from diffusion_e2e_ft_tpu_torch.utils import geometry as tgeo
from test_torch_train_step import state_dict, trainers, weights  # noqa: F401  (weights: the fixture)

K = np.array([[518.8, 0.0, 325.6], [0.0, 519.5, 253.7], [0.0, 0.0, 1.0]])

GEOMETRY = {
    "intrins_from_fov": lambda g: g.intrins_from_fov(60.0, 48, 64),
    "intrins_crop": lambda g: g.intrins_crop(K, 3.0, 5.0),
    "intrins_pad": lambda g: g.intrins_pad(K, 3.0, 5.0),
    "intrins_scale": lambda g: g.intrins_scale(K, 0.5, 0.25),
    "ray_array": lambda g: g.ray_array(K, 12, 16),
    "ray_array_normalized": lambda g: g.ray_array(K, 12, 16, normalize=True),
    "unproject_depth": lambda g: g.unproject_depth(np.arange(12 * 16, dtype=np.float32).reshape(12, 16) / 7, K),
    "rotation_euler": lambda g: g.rotation_euler(10.0, -20.0, 5.0),
    "rotation_euler_radians": lambda g: g.rotation_euler(0.1, 0.2, -0.3, degrees=False),
    "rotation_axis_angle": lambda g: g.rotation_axis_angle(np.array([1.0, 2.0, -0.5]), 33.0),
    "quaternion_to_matrix": lambda g: g.quaternion_to_matrix(np.array([0.9, 0.1, -0.3, 0.2])),
    "rotate_normals": lambda g: g.rotate_normals(_normals(12, 16), g.rotation_euler(5.0, 6.0, 7.0)),
    "homography_warp": lambda g: g.homography_warp(_image(48, 64), K, K, g.rotation_euler(3.0, -2.0, 1.0)),
    "homography_warp_nearest": lambda g: g.homography_warp(_image(48, 64), K, K, g.rotation_euler(3.0, 2.0, 0.0),
                                                           nearest=True),
    "normal_to_rgb": lambda g: g.normal_to_rgb(_normals(12, 16), _mask(12, 16)),
    "depth_to_rgb": lambda g: g.depth_to_rgb(_depth(12, 16), _mask(12, 16)),
    "depth_to_rgb_unmasked": lambda g: g.depth_to_rgb(_depth(12, 16)),
}


def _image(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


def _normals(h, w, seed=1):
    n = np.random.default_rng(seed).normal(size=(h, w, 3)).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _mask(h, w, seed=2):
    return np.random.default_rng(seed).random((h, w)) > 0.2


def _depth(h, w, seed=3):
    return np.random.default_rng(seed).uniform(0.5, 10.0, (h, w)).astype(np.float32)


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_geometry_matches_jax(name):
    got, want = GEOMETRY[name](tgeo), GEOMETRY[name](jgeo)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _sample(h=48, w=64, uint8=False):
    img = _image(h, w)
    return {"img": (img * 255).astype(np.uint8) if uint8 else img, "normal": _normals(h, w),
            "normal_mask": _mask(h, w), "depth": _depth(h, w), "intrins": K.copy()}


TRANSFORMS = {
    "ToFloat": (lambda a: a.ToFloat(), dict(uint8=True)),
    "Resize": (lambda a: a.Resize(32, 40), {}),
    "RandomCrop": (lambda a: a.RandomCrop(32, 40), {}),
    "NyuCrop": (lambda a: a.NyuCrop(), dict(h=480, w=640)),
    "HorizontalFlip": (lambda a: a.HorizontalFlip(p=1.0), {}),
    "ColorJitter": (lambda a: a.ColorJitter(p=1.0), {}),
    "GaussianBlur": (lambda a: a.GaussianBlur(p=1.0), {}),
    "GaussianNoise": (lambda a: a.GaussianNoise(p=1.0), {}),
    "JpegCompression": (lambda a: a.JpegCompression(p=1.0), {}),
    "Normalize": (lambda a: a.Normalize(), {}),
    "RandomRotationWarp": (lambda a: a.RandomRotationWarp(p=1.0), {}),
    "benchmark_transform": (lambda a: a.benchmark_transform(), dict(uint8=True)),
    "training_transform": (lambda a: a.training_transform(32, 40), dict(uint8=True)),
}


def _assert_sample_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_augmentation_matches_jax(name):
    make, sample_kw = TRANSFORMS[name]
    for seed in range(3):
        t, j = make(taug), make(jaug)
        rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = t(_sample(**sample_kw), rng_t), j(_sample(**sample_kw), rng_j)
        _assert_sample_equal(got, want)
        assert rng_t.random() == rng_j.random()  # the same draws were taken


@pytest.mark.parametrize("case", ["masked", "unmasked", "no_clip", "all_invalid"])
def test_near_far_normalizer_matches_jax(case):
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 20.0, (40, 56)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0  # no GT: excluded
    mask = rng.random(depth.shape) > 0.3 if case in ("masked", "no_clip") else None
    if case == "all_invalid":
        depth[:] = 0.0
    kw = {"clip": False} if case == "no_clip" else {}
    got, got_min, got_max = tdt.NearFarMetricNormalizer(**kw)(torch.from_numpy(depth), mask)
    want, want_min, want_max = jdt.NearFarMetricNormalizer(**kw)(depth, mask)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose([got_min, got_max], [want_min, want_max], rtol=1e-6, atol=0)
    back = tdt.NearFarMetricNormalizer(**kw).denormalize(got, got_min, got_max)
    np.testing.assert_allclose(back.numpy(), jdt.NearFarMetricNormalizer(**kw).denormalize(want, want_min, want_max),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(jnl.LOSS_FUNCS))
def test_normal_losses_match_jax(name):
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(2, 24, 32, 3)).astype(np.float32)
    target = _normals(24, 32)[None].repeat(2, 0)
    mask = rng.random((2, 24, 32)) > 0.25
    args = [pred, target, mask]
    if name == "nll_vonmises":
        args.insert(1, rng.uniform(0.1, 30.0, (2, 24, 32, 1)).astype(np.float32))
    got = tnl.LOSS_FUNCS[name](*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    want = jnl.LOSS_FUNCS[name](*(jnp.asarray(a) for a in args))
    assert sorted(tnl.LOSS_FUNCS) == sorted(jnl.LOSS_FUNCS)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    none = tnl.LOSS_FUNCS[name](*(torch.from_numpy(np.ascontiguousarray(a)) for a in args[:-1]),
                                torch.zeros(2, 24, 32, dtype=torch.bool))
    assert float(none) == 0.0  # no valid pixel: a zero mean, not 0/0


def test_odd_latent_train_step_matches_jax(weights):  # noqa: F811
    """The up path meets an odd latent (11x38 -> 6x19 -> 11x38) through the
    backward, with UNet checkpointing, against the JAX trainer."""
    cfg = dict(modality="depth", gradient_checkpointing=True, fused_vae_kernels=False,
               gradient_accumulation_steps=1)
    jt, up, pt = trainers(weights, **cfg)
    rng = np.random.default_rng(6)
    batch = {"rgb": rng.uniform(-1, 1, (2, 22, 76, 3)).astype(np.float32), "val_mask": rng.random((2, 22, 76)) > 0.2,
             "target": rng.uniform(-1, 1, (2, 22, 76)).astype(np.float32)}
    assert pt.vae.encode_mean(torch.zeros(1, 3, 22, 76)).shape[-2:] == (11, 38)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))(
        up, jt._frozen(), {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0)
    )
    loss, _, grads = pt.value_and_grad(batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grads = state_dict(want_grads)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        w = want_grads[name]
        assert float((g - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max())), name
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    want_norm = float(torch.linalg.vector_norm(torch.stack([w.norm() for w in want_grads.values()])))
    np.testing.assert_allclose(norm, want_norm, rtol=1e-5)


def _bfgs_calls(monkeypatch) -> list:
    """Record (objective, x0) of every `scipy.optimize.minimize` call."""
    calls, minimize = [], scipy.optimize.minimize

    def recording(fun, x0, *args, **kwargs):
        calls.append((fun, np.array(x0, np.float64)))
        return minimize(fun, x0, *args, **kwargs)

    monkeypatch.setattr(scipy.optimize, "minimize", recording)
    return calls


def test_bfgs_step_vanishes_in_float32_in_both_packages(monkeypatch):
    """Why the ensemble's BFGS is degenerate in both packages: scipy's
    absolute finite-difference step sqrt(eps64) = 2**-26 = 1.49e-8 is below
    half an ulp of float32 at |x| >= 0.5 and exactly half an ulp on [0.25,
    0.5), where round-half-to-even drops it when x's float32 significand is
    even; both closures cast x to float32, so wherever it drops they return
    their objective at x0 unchanged, and both see the same float32 x."""
    rng = np.random.default_rng(7)
    members = (rng.uniform(0.2, 0.9, (1, 24, 32)) * rng.uniform(0.5, 1.5, (4, 1, 1))
               + rng.uniform(-0.1, 0.1, (4, 1, 1))).astype(np.float32)
    calls = _bfgs_calls(monkeypatch)
    jens.ensemble_depths(jnp.asarray(members))
    tens.align_depths(torch.from_numpy(members))
    assert len(calls) == 2
    (jfun, jx0), (tfun, tx0) = calls
    np.testing.assert_array_equal(tx0, jx0)  # the same float32 start
    step = np.sqrt(np.finfo(np.float64).eps)
    assert step == 2.0**-26
    x32 = jx0.astype(np.float32)
    even = (x32.view(np.uint32) & 1) == 0
    drops = (np.abs(jx0) >= 0.5) | ((np.abs(jx0) >= 0.25) & even)
    assert (np.abs(jx0) >= 0.5).sum() >= 4  # the scales start near 1
    for i in np.flatnonzero(np.abs(jx0) >= 0.25):
        assert (np.float32(jx0[i] + step) == x32[i]) == drops[i], i
    for fun, x0 in ((jfun, jx0), (tfun, tx0)):
        at_x0 = fun(x0)
        for i in np.flatnonzero(drops):
            x = x0.copy()
            x[i] += step
            assert fun(x) == at_x0, i
