"""Diffusion noise schedules, timestep plans and sampling steps (DDIM,
ancestral DDPM, latent consistency), and the forward process the
diffusion-loss trainer needs (`add_noise`, `velocity`): port of
`diffusion_e2e_ft_tpu/ops/scheduler.py`.

Timestep plans are host-side numpy (identical arithmetic to the JAX package);
schedules are tensors on the pipeline's device. Where a JAX step takes a PRNG
key, its counterpart here takes the noise tensor itself (`noise=`), drawn by
the caller from a `torch.Generator`: the draw is the caller's, the step is
deterministic given it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

Timestep = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """SD2 (v-prediction) defaults with trailing timestep spacing."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "v_prediction"  # epsilon | v_prediction | sample
    timestep_spacing: str = "trailing"  # trailing | leading | linspace
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = False
    rescale_betas_zero_snr: bool = False
    # LCM (latent consistency) sampling parameters; only the lcm_* path reads them
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0

    def replace(self, **kw) -> "SchedulerConfig":
        return dataclasses.replace(self, **kw)


class Schedule(NamedTuple):
    betas: torch.Tensor  # [T]
    alphas_cumprod: torch.Tensor  # [T]
    final_alpha_cumprod: torch.Tensor  # [] alpha-bar used when prev_t < 0


def _compute_betas(config: SchedulerConfig) -> np.ndarray:
    T = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, T, dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, T, dtype=np.float64) ** 2
    elif config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        betas = np.array(
            [min(1 - alpha_bar((i + 1) / T) / alpha_bar(i / T), 0.999) for i in range(T)],
            dtype=np.float64,
        )
    else:
        raise ValueError(f"Unknown beta_schedule: {config.beta_schedule}")
    if config.rescale_betas_zero_snr:
        betas = _rescale_zero_terminal_snr(betas)
    return betas.astype(np.float32)


def _rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale the schedule so that the terminal SNR is exactly zero (Lin et al. 2023)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def make_schedule(config: SchedulerConfig, device=None, dtype=torch.float32) -> Schedule:
    betas = _compute_betas(config)
    acp = np.cumprod(1.0 - betas.astype(np.float64)).astype(np.float32)
    final = np.float32(1.0) if config.set_alpha_to_one else acp[0]
    return Schedule(
        betas=torch.as_tensor(betas, dtype=dtype, device=device),
        alphas_cumprod=torch.as_tensor(acp, dtype=dtype, device=device),
        final_alpha_cumprod=torch.as_tensor(final, dtype=dtype, device=device),
    )


def inference_timesteps(config: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending timestep plan for K inference steps (host-side, static)."""
    T = config.num_train_timesteps
    if num_inference_steps < 1 or num_inference_steps > T:
        raise ValueError(f"num_inference_steps must be in [1, {T}]")
    spacing = config.timestep_spacing
    if spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / num_inference_steps)).astype(np.int64) - 1
    elif spacing == "leading":
        step_ratio = T // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
        ts = ts.astype(np.int64) + config.steps_offset
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1].copy().astype(np.int64)
    else:
        raise ValueError(f"Unknown timestep_spacing: {spacing}")
    return ts.astype(np.int32)


def previous_timesteps(
    config: SchedulerConfig, timesteps: np.ndarray, num_inference_steps: int
) -> np.ndarray:
    """prev_t for each plan entry; may go negative at the boundary."""
    return (timesteps - config.num_train_timesteps // num_inference_steps).astype(np.int32)


class DenoisePlan(NamedTuple):
    timesteps: np.ndarray  # [K] int32, descending
    prev_timesteps: np.ndarray  # [K] int32


def make_plan(config: SchedulerConfig, num_inference_steps: int) -> DenoisePlan:
    ts = inference_timesteps(config, num_inference_steps)
    return DenoisePlan(ts, previous_timesteps(config, ts, num_inference_steps))


def _per_sample(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A scalar as it is; a per-sample [B] tensor right-padded with singleton
    dims to broadcast over [B, ...] samples of `ndim` dims."""
    return x if x.ndim == 0 else x.reshape(x.shape + (1,) * (ndim - x.ndim))


def _extract(arr: torch.Tensor, t: Timestep, ndim: int) -> torch.Tensor:
    """arr[t] (clipped to range), per sample for a batch of t."""
    t = torch.as_tensor(t, device=arr.device).long().clamp(0, arr.shape[0] - 1)
    return _per_sample(arr[t], ndim)


def pred_original_sample(
    config: SchedulerConfig, schedule: Schedule, model_output: torch.Tensor, t: Timestep,
    sample: torch.Tensor,
) -> torch.Tensor:
    """The x0 estimate implied by the model's parameterized prediction."""
    a_t = _extract(schedule.alphas_cumprod, t, sample.ndim)
    b_t = 1.0 - a_t
    if config.prediction_type == "v_prediction":
        x0 = a_t.sqrt() * sample - b_t.sqrt() * model_output
    elif config.prediction_type == "epsilon":
        x0 = (sample - b_t.sqrt() * model_output) / a_t.sqrt()
    elif config.prediction_type == "sample":
        x0 = model_output
    else:
        raise ValueError(f"Unknown prediction_type: {config.prediction_type}")
    if config.clip_sample:
        x0 = x0.clamp(-config.clip_sample_range, config.clip_sample_range)
    return x0


def pred_epsilon(
    config: SchedulerConfig, schedule: Schedule, model_output: torch.Tensor, t: Timestep,
    sample: torch.Tensor,
) -> torch.Tensor:
    """The noise estimate implied by the model output."""
    a_t = _extract(schedule.alphas_cumprod, t, sample.ndim)
    b_t = 1.0 - a_t
    if config.prediction_type == "v_prediction":
        return a_t.sqrt() * model_output + b_t.sqrt() * sample
    if config.prediction_type == "epsilon":
        return model_output
    if config.prediction_type == "sample":
        return (sample - a_t.sqrt() * model_output) / b_t.sqrt()
    raise ValueError(f"Unknown prediction_type: {config.prediction_type}")


def add_noise(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor, t: Timestep) -> torch.Tensor:
    """Forward-process sample: sqrt(a_t) x0 + sqrt(1 - a_t) noise."""
    a_t = _extract(schedule.alphas_cumprod, t, x0.ndim)
    return a_t.sqrt() * x0 + (1.0 - a_t).sqrt() * noise


def velocity(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor, t: Timestep) -> torch.Tensor:
    """v-target: sqrt(a_t) noise - sqrt(1 - a_t) x0."""
    a_t = _extract(schedule.alphas_cumprod, t, x0.ndim)
    return a_t.sqrt() * noise - (1.0 - a_t).sqrt() * x0


class StepOutput(NamedTuple):
    prev_sample: torch.Tensor
    pred_original_sample: torch.Tensor


def _alpha_prev(schedule: Schedule, prev_t: Timestep, ndim: int) -> torch.Tensor:
    prev = torch.as_tensor(prev_t, device=schedule.alphas_cumprod.device)
    a_prev = _extract(schedule.alphas_cumprod, prev.clamp_min(0), ndim)
    return torch.where(_per_sample(prev < 0, ndim), schedule.final_alpha_cumprod, a_prev)


def ddim_step(
    config: SchedulerConfig, schedule: Schedule, model_output: torch.Tensor, t: Timestep,
    prev_t: Timestep, sample: torch.Tensor, *, eta: float = 0.0, noise: Optional[torch.Tensor] = None,
) -> StepOutput:
    """One deterministic (eta = 0) or stochastic DDIM update x_t -> x_{prev_t},
    plus the x0 estimate. eta > 0 needs `noise` (shaped as `sample`)."""
    x0 = pred_original_sample(config, schedule, model_output, t, sample)
    eps = pred_epsilon(config, schedule, model_output, t, sample)
    a_prev = _alpha_prev(schedule, prev_t, sample.ndim)
    sigma = torch.zeros_like(a_prev)
    if eta > 0.0:
        if noise is None:
            raise ValueError("eta > 0 requires noise")
        a_t = _extract(schedule.alphas_cumprod, t, sample.ndim)
        sigma = eta * ((1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)).sqrt()
    prev_sample = a_prev.sqrt() * x0 + (1.0 - a_prev - sigma**2).clamp_min(0.0).sqrt() * eps
    return StepOutput(prev_sample if eta <= 0.0 else prev_sample + sigma * noise, x0)


def ddpm_step(
    config: SchedulerConfig, schedule: Schedule, model_output: torch.Tensor, t: Timestep,
    prev_t: Timestep, sample: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
    variance_type: str = "fixed_small",
) -> StepOutput:
    """One ancestral DDPM update x_t -> x_{prev_t}: the posterior mean plus
    std * noise wherever prev_t >= 0 (no noise given: zeros, as the JAX step
    without a key)."""
    x0 = pred_original_sample(config, schedule, model_output, t, sample)
    a_t = _extract(schedule.alphas_cumprod, t, sample.ndim)
    a_prev = _alpha_prev(schedule, prev_t, sample.ndim)
    current_alpha = a_t / a_prev
    current_beta = 1.0 - current_alpha
    coef_x0 = a_prev.sqrt() * current_beta / (1.0 - a_t)
    coef_xt = current_alpha.sqrt() * (1.0 - a_prev) / (1.0 - a_t)
    mean = coef_x0 * x0 + coef_xt * sample
    variance = ((1.0 - a_prev) / (1.0 - a_t) * current_beta).clamp_min(1e-20)
    if variance_type == "fixed_large":
        variance = current_beta
    noise = torch.zeros_like(sample) if noise is None else noise
    add = _per_sample(torch.as_tensor(prev_t, device=sample.device) >= 0, sample.ndim)
    return StepOutput(mean + torch.where(add, variance.sqrt() * noise, 0.0), x0)


def lcm_step(
    config: SchedulerConfig, schedule: Schedule, model_output: torch.Tensor, t: Timestep,
    prev_t: Timestep, sample: torch.Tensor, *, noise: Optional[torch.Tensor] = None, is_last=True,
) -> StepOutput:
    """One latent-consistency update x_t -> x_{prev_t}: the x0 estimate blended
    with the sample by the consistency boundary scalings (sigma_data = 0.5, t
    scaled by `timestep_scaling`), re-noised to prev_t on every step but the
    last, which returns the denoised estimate itself."""
    x0 = pred_original_sample(config, schedule, model_output, t, sample)
    sigma_data = 0.5
    scaled_t = torch.as_tensor(t, device=sample.device).float() * config.timestep_scaling
    c_skip = _per_sample(sigma_data**2 / (scaled_t**2 + sigma_data**2), sample.ndim)
    c_out = _per_sample(scaled_t / (scaled_t**2 + sigma_data**2).sqrt(), sample.ndim)
    denoised = c_out * x0 + c_skip * sample
    a_prev = _alpha_prev(schedule, prev_t, sample.ndim)
    noise = torch.zeros_like(sample) if noise is None else noise
    renoised = a_prev.sqrt() * denoised + (1.0 - a_prev).sqrt() * noise
    is_last = _per_sample(torch.as_tensor(is_last, device=sample.device), sample.ndim)
    return StepOutput(torch.where(is_last, denoised, renoised), denoised)


def lcm_timesteps(
    config: SchedulerConfig, num_inference_steps: int, original_inference_steps: Optional[int] = None
) -> np.ndarray:
    """The LCM plan: the distilled schedule's timesteps (k * i - 1 for its
    original_inference_steps), descending, subsampled with an even stride."""
    T = config.num_train_timesteps
    origin = original_inference_steps or config.original_inference_steps
    if num_inference_steps > origin:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) cannot exceed the distilled "
            f"original_inference_steps ({origin})"
        )
    lcm_origin = np.arange(1, origin + 1, dtype=np.int64) * (T // origin) - 1
    skipping = len(lcm_origin) // num_inference_steps
    return lcm_origin[::-1][::skipping][:num_inference_steps].astype(np.int32)


def make_lcm_plan(config: SchedulerConfig, num_inference_steps: int) -> DenoisePlan:
    """LCM plan: prev_t is the next plan entry (not t - T/K); the last is -1."""
    ts = lcm_timesteps(config, num_inference_steps)
    return DenoisePlan(ts, np.concatenate([ts[1:], np.asarray([-1], np.int32)]).astype(np.int32))
