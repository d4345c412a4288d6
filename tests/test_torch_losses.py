"""The task losses of the torch port (`ops/losses.py`) against the JAX
package's, on the same numpy inputs, values and gradients. fp32 on both
sides; the masked sums differ only in summation order, so the bound is 1e-6
(relative to max(1, |value|))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu.ops import losses as J
from diffusion_e2e_ft_tpu_torch.ops import losses as T

TOL = dict(rtol=1e-6, atol=1e-6)


def _depth(seed, shape=(3, 12, 16), p_valid=0.7):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=shape).astype(np.float32)
    target = rng.uniform(-1, 1, size=shape).astype(np.float32)
    mask = rng.random(shape) < p_valid
    return pred, target, mask


def _normals(seed, shape=(2, 10, 14)):
    rng = np.random.default_rng(seed)
    pred, target = (rng.normal(size=shape + (3,)).astype(np.float32) for _ in range(2))
    pred /= np.linalg.norm(pred, axis=-1, keepdims=True) + 1e-5
    target /= np.linalg.norm(target, axis=-1, keepdims=True)
    return pred, target, rng.random(shape) < 0.7


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def test_scale_and_shift_matches():
    pred, target, mask = _depth(0)
    want = J.compute_scale_and_shift(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = T.compute_scale_and_shift(*_t(pred, target, mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_det_guard():
    """A constant prediction makes the 2x2 system singular (det == 0): scale and
    shift are 0, as in the JAX package, and the loss is the target's mean |y|."""
    pred = np.ones((2, 8, 8), np.float32)
    target = np.random.default_rng(1).uniform(-1, 1, (2, 8, 8)).astype(np.float32)
    mask = np.ones((2, 8, 8), bool)
    s, t = T.compute_scale_and_shift(*_t(pred, target, mask))
    assert s.tolist() == [0.0, 0.0] and t.tolist() == [0.0, 0.0]
    want = J.ssi_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    np.testing.assert_allclose(float(T.ssi_loss(*_t(pred, target, mask))), float(want), **TOL)


@pytest.mark.parametrize("four_d", [False, True], ids=["bhw", "bhw1"])
def test_ssi_loss_and_grad_match(four_d):
    pred, target, mask = _depth(2)
    if four_d:
        pred, target, mask = pred[..., None], target[..., None], mask[..., None]
    want, want_g = jax.value_and_grad(J.ssi_loss)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_()
    got = T.ssi_loss(p, *_t(target, mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)


def test_angular_loss_and_grad_match():
    pred, target, mask = _normals(3)
    want, want_g = jax.value_and_grad(J.angular_loss)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    p = torch.from_numpy(pred).requires_grad_()
    got = T.angular_loss(p, *_t(target, mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("loss", ["ssi_loss", "angular_loss"])
def test_all_invalid_mask_gives_zero(loss):
    pred, target, _ = _normals(4) if loss == "angular_loss" else _depth(4)
    mask = np.zeros(pred.shape[:3], bool)
    want = getattr(J, loss)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    got = getattr(T, loss)(*_t(pred, target, mask))
    assert float(got) == float(want) == 0.0


def test_nan_guarded():
    x = torch.tensor([float("nan"), 0.5, float("inf")])
    got = torch.stack([T.nan_guarded(v) for v in x])
    want = np.asarray([J.nan_guarded(jnp.asarray(v)) for v in x.numpy()])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [0.0, 0.5, float("inf")]
