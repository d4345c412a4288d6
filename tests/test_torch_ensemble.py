"""The port's ensembling (`ops/ensemble.py`) against the JAX package, fp32 on the CPU.

The depth ensemble is a scipy BFGS with numerical gradients over a float32
objective. scipy's finite-difference step (1.5e-8) is below the objective's
rounding (its float32 ulp near 0.1 is 7e-9; a scale near 1 moves by 1.2e-7 an
ulp), so the gradients it estimates are mostly rounding, and two summation
orders of the same objective walk BFGS to other (s, t). The tests therefore
hold the parts tightly and the whole within a drift:

- `_median_lower`: exact (a selection);
- the objective at the same (s, t): relative 1e-5 (summation order of the
  pairwise mean; measured 6e-7);
- the combine step given the JAX package's own BFGS result: 1e-5;
- `ensemble_depths` end to end: `ENSEMBLE_DRIFT` (0.1, `_torch_port.py` says
  where it comes from) on the depth and the uncertainty, both in [0, 1]
  units. A wrong reduction or alignment is caught by the tight tests above,
  not by this one;
- `ensemble_normals`: the same member, and its values to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import ENSEMBLE_DRIFT
from diffusion_e2e_ft_tpu.ops import ensemble as je
from diffusion_e2e_ft_tpu_torch.ops import ensemble as te


def noisy_affine_copies(seed: int, n: int, hw) -> np.ndarray:
    """n affine transforms of one map, each with its own noise: what an
    ensemble of affine-invariant depth predictions looks like."""
    rng = np.random.default_rng(seed)
    base = rng.random(hw).astype(np.float32)
    return np.stack([base * rng.uniform(0.5, 2.0) + rng.uniform(-0.3, 0.3) + 0.05 * rng.standard_normal(hw)
                     for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 10])
def test_median_lower_matches(n):
    x = np.random.default_rng(n).standard_normal((n, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(te._median_lower(torch.from_numpy(x)).numpy(), np.asarray(je._median_lower(x)))
    if n % 2 == 0:  # the lower of the two middle values, not their mean
        np.testing.assert_array_equal(te._median_lower(torch.from_numpy(x)).numpy(), np.sort(x, axis=0)[n // 2 - 1])


@pytest.mark.parametrize("reduction", ["median", "mean"])
@pytest.mark.parametrize("n", [2, 3, 4, 10])
def test_objective_matches(reduction, n):
    images = noisy_affine_copies(n, n, (24, 32))
    rng = np.random.default_rng(100 + n)
    for _ in range(5):
        s, t = rng.uniform(0.3, 2.0, n).astype(np.float32), rng.uniform(-0.5, 0.5, n).astype(np.float32)
        want = float(je._depth_objective(jnp.asarray(images), jnp.asarray(s), jnp.asarray(t), reduction=reduction,
                                         regularizer_strength=0.05))
        got = float(te._depth_objective(torch.from_numpy(images), torch.from_numpy(s), torch.from_numpy(t), reduction,
                                        0.05))
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def jax_bfgs(monkeypatch, images, **kw):
    """The JAX `ensemble_depths` output and the (s, t) its BFGS found."""
    import scipy.optimize

    found = []
    minimize = scipy.optimize.minimize

    def recording(*args, **kwargs):
        found.append(minimize(*args, **kwargs))
        return found[-1]

    monkeypatch.setattr(scipy.optimize, "minimize", recording)
    depth, unc = je.ensemble_depths(images, **kw)
    monkeypatch.setattr(scipy.optimize, "minimize", minimize)
    n = images.shape[0]
    return depth, unc, found[-1].x[:n], found[-1].x[n:]


@pytest.mark.parametrize("reduction", ["median", "mean"])
@pytest.mark.parametrize("n", [3, 4])
def test_combine_matches_given_jax_alignment(monkeypatch, reduction, n):
    images = noisy_affine_copies(20 + n, n, (40, 56))
    want_d, want_u, s, t = jax_bfgs(monkeypatch, images, reduction=reduction)
    got_d, got_u = te.combine_depths(torch.from_numpy(images), s, t, reduction)
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_u.numpy(), want_u, atol=1e-5, rtol=0)


def test_alignment_starts_where_jax_starts(monkeypatch):
    """The BFGS start (min-max scale and shift of each member) is the JAX one
    exactly: with no iteration allowed, both stop at it."""
    images = noisy_affine_copies(3, 4, (30, 20))
    _, _, s_want, t_want = jax_bfgs(monkeypatch, images, max_iter=0)
    s, t = te.align_depths(torch.from_numpy(images), max_iter=0)
    np.testing.assert_array_equal(s, s_want)
    np.testing.assert_array_equal(t, t_want)


# both reductions, with and without a max_res that downsamples (each case is a BFGS run in both packages:
# dozens of small sequential calls, slow on a loaded CPU)
@pytest.mark.parametrize("seed,n,hw,reduction,max_res", [
    (0, 3, (64, 48), "median", None), (1, 5, (96, 128), "mean", 40), (2, 10, (60, 80), "median", 40),
    (3, 4, (32, 40), "mean", None)])
def test_ensemble_depths_within_drift(reduction, max_res, seed, n, hw):
    images = noisy_affine_copies(seed, n, hw)
    want_d, want_u = je.ensemble_depths(images, reduction=reduction, max_res=max_res)
    got_d, got_u = te.ensemble_depths(torch.from_numpy(images), reduction=reduction, max_res=max_res)
    assert got_d.shape == got_u.shape == hw
    assert float(got_d.min()) == 0.0 and abs(float(got_d.max()) - 1.0) < 1e-6 and float(got_u.min()) >= 0.0
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=ENSEMBLE_DRIFT, rtol=0)
    np.testing.assert_allclose(got_u.numpy(), want_u, atol=ENSEMBLE_DRIFT, rtol=0)


def test_downsampling_matches_jax_nearest():
    """`max_res` downsamples with half-pixel centres, as `jax.image.resize`'s nearest."""
    import jax

    images = noisy_affine_copies(4, 3, (60, 80))
    for max_res in (40, 37, 13):
        scale = min(max_res / 60, max_res / 80)
        size = (int(60 * scale), int(80 * scale))
        want = np.asarray(jax.image.resize(jnp.asarray(images), (3, *size), method="nearest"))
        got = torch.nn.functional.interpolate(torch.from_numpy(images)[None], size=size, mode="nearest-exact")[0]
        np.testing.assert_array_equal(got.numpy(), want)


def test_single_member_is_min_max():
    d = np.random.default_rng(5).uniform(2.0, 5.0, (1, 16, 12)).astype(np.float32)
    want_d, want_u = je.ensemble_depths(d)
    got_d, got_u = te.ensemble_depths(torch.from_numpy(d))
    np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-6, rtol=0)
    assert not got_u.any() and not want_u.any()


@pytest.mark.parametrize("n", [2, 3, 5])
def test_ensemble_normals_picks_the_same_member(n):
    """Members are one field plus noise of distinct strengths, so each has its
    own total angular error and the closest is unambiguous."""
    rng = np.random.default_rng(n)
    base = rng.standard_normal((12, 10, 3)).astype(np.float32)
    base[..., 2] = np.abs(base[..., 2]) + 0.5  # facing the camera
    strengths = rng.permutation(np.linspace(0.05, 0.6, n))
    members = np.stack([base + s * rng.standard_normal(base.shape) for s in strengths]).astype(np.float32)
    want = np.asarray(je.ensemble_normals(jnp.asarray(members)))
    got = te.ensemble_normals(torch.from_numpy(members)).numpy()
    unit = members / (np.linalg.norm(members, axis=-1, keepdims=True) + 1e-5)
    index = [i for i in range(n) if np.allclose(unit[i], got, atol=1e-6)]
    assert index == [i for i in range(n) if np.allclose(unit[i], want, atol=1e-6)] and len(index) == 1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
