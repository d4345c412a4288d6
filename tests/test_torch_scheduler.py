"""Scheduler parity, torch port vs the JAX package: DDIM (eta = 0 and > 0),
ancestral DDPM and latent-consistency steps, the DDIM and LCM plans, and the
HF scheduler config.

Timestep plans are integer arithmetic and must match exactly. Schedules and
steps are fp32 in both; 1e-6 covers the last-ulp differences of sqrt and the
products. Where a JAX step draws from a key, the port's step is given that
draw (`jax.random.normal(key, shape)`)."""

import dataclasses

import jax
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


# ---- the stochastic steps: the JAX step draws `jax.random.normal(key, shape)`; the port's takes that draw ----

def _step_inputs(seed, shape=(2, 4, 3, 5)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("variance_type", ["fixed_small", "fixed_large"])
@pytest.mark.parametrize("t,prev_t", [(999, 979), (749, 499), (20, -1)])
def test_ddpm_step_matches(variance_type, t, prev_t):
    """Noise is added only where prev_t >= 0; the last step is the posterior mean."""
    jc, tc = _cfgs()
    out, sample = _step_inputs(t)
    key = jax.random.key(t)
    noise = np.array(jax.random.normal(key, sample.shape, jnp.float32))
    j = js.ddpm_step(jc, js.make_schedule(jc), jnp.asarray(out), t, prev_t, jnp.asarray(sample), key=key,
                     variance_type=variance_type)
    r = ts.ddpm_step(tc, ts.make_schedule(tc), torch.from_numpy(out), t, prev_t, torch.from_numpy(sample),
                     noise=torch.from_numpy(noise), variance_type=variance_type)
    np.testing.assert_allclose(r.prev_sample.numpy(), np.asarray(j.prev_sample), atol=1e-6, rtol=0)
    np.testing.assert_allclose(r.pred_original_sample.numpy(), np.asarray(j.pred_original_sample), atol=1e-6, rtol=0)
    # without noise: zeros, as the JAX step without a key
    j0 = js.ddpm_step(jc, js.make_schedule(jc), jnp.asarray(out), t, prev_t, jnp.asarray(sample))
    r0 = ts.ddpm_step(tc, ts.make_schedule(tc), torch.from_numpy(out), t, prev_t, torch.from_numpy(sample))
    np.testing.assert_allclose(r0.prev_sample.numpy(), np.asarray(j0.prev_sample), atol=1e-6, rtol=0)


@pytest.mark.parametrize("is_last", [False, True], ids=["intermediate", "final"])
@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("t,prev_t", [(999, 759), (259, 19), (19, -1)])
def test_lcm_step_matches(is_last, prediction_type, t, prev_t):
    jc, tc = _cfgs(prediction_type=prediction_type, timestep_scaling=10.0)
    out, sample = _step_inputs(t + 1)
    key = jax.random.key(t + 1)
    noise = np.array(jax.random.normal(key, sample.shape, jnp.float32))
    j = js.lcm_step(jc, js.make_schedule(jc), jnp.asarray(out), t, prev_t, jnp.asarray(sample), key=key,
                    is_last=is_last)
    r = ts.lcm_step(tc, ts.make_schedule(tc), torch.from_numpy(out), t, prev_t, torch.from_numpy(sample),
                    noise=torch.from_numpy(noise), is_last=is_last)
    np.testing.assert_allclose(r.prev_sample.numpy(), np.asarray(j.prev_sample), atol=1e-6, rtol=0)
    np.testing.assert_allclose(r.pred_original_sample.numpy(), np.asarray(j.pred_original_sample), atol=1e-6, rtol=0)
    if is_last:  # the final step returns the denoised estimate itself
        np.testing.assert_array_equal(r.prev_sample.numpy(), r.pred_original_sample.numpy())


def test_lcm_step_batched_timesteps_match():
    jc, tc = _cfgs()
    out, sample = _step_inputs(7, (3, 4, 2, 2))
    t, prev = np.asarray([999, 499, 19]), np.asarray([759, 259, -1])
    key = jax.random.key(7)
    noise = np.array(jax.random.normal(key, sample.shape, jnp.float32))
    j = js.lcm_step(jc, js.make_schedule(jc), jnp.asarray(out), jnp.asarray(t), jnp.asarray(prev),
                    jnp.asarray(sample), key=key, is_last=False)
    r = ts.lcm_step(tc, ts.make_schedule(tc), torch.from_numpy(out), torch.from_numpy(t), torch.from_numpy(prev),
                    torch.from_numpy(sample), noise=torch.from_numpy(noise), is_last=False)
    np.testing.assert_allclose(r.prev_sample.numpy(), np.asarray(j.prev_sample), atol=1e-6, rtol=0)


@pytest.mark.parametrize("eta", [0.5, 1.0])
@pytest.mark.parametrize("t,prev_t", [(999, 749), (260, 10), (10, -240)])
def test_ddim_step_with_eta_matches(eta, t, prev_t):
    jc, tc = _cfgs()
    out, sample = _step_inputs(t + 2)
    key = jax.random.key(t + 2)
    noise = np.array(jax.random.normal(key, sample.shape, jnp.float32))
    j = js.ddim_step(jc, js.make_schedule(jc), jnp.asarray(out), t, prev_t, jnp.asarray(sample), eta=eta, key=key)
    r = ts.ddim_step(tc, ts.make_schedule(tc), torch.from_numpy(out), t, prev_t, torch.from_numpy(sample), eta=eta,
                     noise=torch.from_numpy(noise))
    np.testing.assert_allclose(r.prev_sample.numpy(), np.asarray(j.prev_sample), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="noise"):  # as the JAX step raises without a key
        ts.ddim_step(tc, ts.make_schedule(tc), torch.from_numpy(out), t, prev_t, torch.from_numpy(sample), eta=eta)


@pytest.mark.parametrize("original", [50, 25, 8])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_lcm_plans_match_exactly(original, k):
    jc, tc = _cfgs(original_inference_steps=original)
    np.testing.assert_array_equal(ts.lcm_timesteps(tc, k), js.lcm_timesteps(jc, k))
    jp, tp = js.make_lcm_plan(jc, k), ts.make_lcm_plan(tc, k)
    np.testing.assert_array_equal(tp.timesteps, jp.timesteps)
    np.testing.assert_array_equal(tp.prev_timesteps, jp.prev_timesteps)
    assert tp.timesteps.dtype == tp.prev_timesteps.dtype == np.int32 and tp.prev_timesteps[-1] == -1
    np.testing.assert_array_equal(ts.lcm_timesteps(ts.SchedulerConfig(), k, original), js.lcm_timesteps(
        js.SchedulerConfig(), k, original))


def test_lcm_plan_beyond_the_distilled_steps_raises():
    jc, tc = _cfgs(original_inference_steps=4)
    with pytest.raises(ValueError, match="original_inference_steps"):
        js.make_lcm_plan(jc, 5)
    with pytest.raises(ValueError, match="original_inference_steps"):
        ts.make_lcm_plan(tc, 5)


def test_config_fields_and_replace_match():
    names = [f.name for f in dataclasses.fields(ts.SchedulerConfig)]
    assert names == [f.name for f in dataclasses.fields(js.SchedulerConfig)]
    assert ts.SchedulerConfig().replace(timestep_scaling=5.0) == ts.SchedulerConfig(timestep_scaling=5.0)


@pytest.mark.parametrize("class_name", ["LCMScheduler", "DDIMScheduler", "DDPMScheduler"])
def test_scheduler_config_round_trip(class_name):
    """The HF scheduler config carries the LCM distillation fields
    (`original_inference_steps`, `timestep_scaling`) through both packages'
    writers and readers; a non-LCM class writes the JAX key set without them."""
    from diffusion_e2e_ft_tpu.pipelines import loading as jl
    from diffusion_e2e_ft_tpu_torch.pipelines import loading as tl

    kw = dict(original_inference_steps=25, timestep_scaling=5.0, timestep_spacing="leading")
    jc, tc = _cfgs(**kw)
    written = tl.scheduler_config_to_hf(tc, class_name)
    assert written == jl.scheduler_config_to_hf(jc, class_name)
    assert ("original_inference_steps" in written) == (class_name == "LCMScheduler")
    back = tl.scheduler_config_from_hf(written)
    assert dataclasses.asdict(back) == dataclasses.asdict(jl.scheduler_config_from_hf(written))
    if class_name == "LCMScheduler":
        assert back == tc and back.original_inference_steps == 25 and back.timestep_scaling == 5.0
        np.testing.assert_array_equal(ts.make_lcm_plan(back, 4).timesteps, js.make_lcm_plan(jc, 4).timesteps)
