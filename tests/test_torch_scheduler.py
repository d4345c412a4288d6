"""DDIM scheduler parity, torch port vs the JAX package.

Timestep plans are integer arithmetic and must match exactly. Schedules and
steps are fp32 in both; 1e-6 covers the last-ulp differences of sqrt and the
products."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffusion_e2e_ft_tpu.ops import scheduler as js
from diffusion_e2e_ft_tpu_torch.ops import scheduler as ts


def _cfgs(**kw):
    return js.SchedulerConfig(**kw), ts.SchedulerConfig(**kw)


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
@pytest.mark.parametrize("k", [1, 4, 10])
def test_plans_match_exactly(spacing, k):
    jc, tc = _cfgs(timestep_spacing=spacing)
    np.testing.assert_array_equal(ts.inference_timesteps(tc, k), js.inference_timesteps(jc, k))
    jp, tp = js.make_plan(jc, k), ts.make_plan(tc, k)
    np.testing.assert_array_equal(tp.timesteps, jp.timesteps)
    np.testing.assert_array_equal(tp.prev_timesteps, jp.prev_timesteps)


def test_single_step_trailing_visits_999():
    assert ts.make_plan(ts.SchedulerConfig(), 1).timesteps.tolist() == [999]


@pytest.mark.parametrize("beta_schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("zero_snr", [False, True])
def test_schedule_matches(beta_schedule, zero_snr):
    jc, tc = _cfgs(beta_schedule=beta_schedule, rescale_betas_zero_snr=zero_snr)
    j, t = js.make_schedule(jc), ts.make_schedule(tc)
    for name in ("betas", "alphas_cumprod", "final_alpha_cumprod"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon", "sample"])
@pytest.mark.parametrize("t,prev_t", [(999, -1), (749, 499), (10, -240)])
def test_ddim_step_matches(prediction_type, t, prev_t):
    jc, tc = _cfgs(prediction_type=prediction_type)
    rng = np.random.default_rng(t)
    out = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    sample = rng.standard_normal((2, 4, 3, 5)).astype(np.float32)
    j = js.ddim_step(jc, js.make_schedule(jc), jnp.asarray(out), t, prev_t, jnp.asarray(sample))
    r = ts.ddim_step(tc, ts.make_schedule(tc), torch.from_numpy(out), t, prev_t, torch.from_numpy(sample))
    np.testing.assert_allclose(r.prev_sample.numpy(), np.asarray(j.prev_sample), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        r.pred_original_sample.numpy(), np.asarray(j.pred_original_sample), atol=1e-6, rtol=0
    )


def test_batched_timesteps_match():
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    out, sample = (rng.standard_normal((3, 4, 2, 2)).astype(np.float32) for _ in range(2))
    t, prev = np.asarray([999, 500, 20]), np.asarray([-1, 250, -230])
    j = js.ddim_step(jc, js.make_schedule(jc), jnp.asarray(out), jnp.asarray(t), jnp.asarray(prev), jnp.asarray(sample))
    r = ts.ddim_step(tc, ts.make_schedule(tc), torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(prev),
                     torch.from_numpy(sample))
    np.testing.assert_allclose(r.prev_sample.numpy(), np.asarray(j.prev_sample), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["add_noise", "velocity"])
@pytest.mark.parametrize("t", [999, 500, 0, np.asarray([999, 3, 640])], ids=["999", "500", "0", "batch"])
def test_forward_process_matches(fn, t):
    """The diffusion-loss trainer's add_noise and v-target: [B, C, H, W] here,
    [B, H, W, C] in the JAX package (t broadcasts over the trailing dims)."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(5)
    x0, noise = (rng.standard_normal((3, 4, 5, 6)).astype(np.float32) for _ in range(2))
    want = getattr(js, fn)(js.make_schedule(jc), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    got = getattr(ts, fn)(ts.make_schedule(tc), torch.from_numpy(x0), torch.from_numpy(noise), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
