"""The port's side of the golden outputs: rebuild a golden's modules from its
`meta`, fill them by the rule of `tests/_torch_golden.py` (checking the
digest), run the port on the stored inputs, and compare with the stored
JAX outputs.

Shared by `tests/test_torch_golden.py` (the CPU, Tier-1) and
`chip_smoke.py`'s phase 20 (the card, which loads it by its path). It
imports numpy, torch, the rule and the port; never JAX or the JAX package.

`BOUNDS[name]` holds each stored output's bound against the port on the CPU
in fp32, those of the existing parity test of the same path
(tests/test_torch_*.py), as (kind, bound): "abs" max |d|; "rel" |d| / |want|
of a scalar; "rtol" elementwise |d| <= bound |want|; "equal" to the bit;
"sums" a train step's per-leaf parameter sums, whose bound follows from a
per-element bound on the parameters after the update (`leaf_sum_bounds`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

import _torch_golden as R

# the existing parity tests' bounds, by path
DEVICE_BODY = 1e-4  # test_torch_pipeline / test_torch_geowizard: the device bodies, one or three steps
# Marigold's normals, one step or an ensemble's three-step members: unit-normalising amplifies the towers'
# differences where |decoded| is small, so the same single-step output through `__call__` is held at 1e-3
# (test_torch_pipeline.test_call_matches; the members at MEMBER_BOUND[True], 5e-3); on the rule's weights at
# 64x64, 6 of 4096 pixels, where |decoded| is 0.0086 (64x under its median), read up to 2.7e-4 against JAX
NORMALS = 1e-3
COMBINE = 1e-5  # test_torch_ensemble: combine_depths at a given (s, t)
LOSS_RTOL = 1e-5  # test_torch_train_step / test_torch_geowizard_trainer: loss, per-loss metrics, grad norm
PARAM_ELEMENT = 1e-6  # ... each parameter after the optimizer update (adam_epsilon 1e-3)
METRIC_RTOL = 1e-5  # test_torch_eval_metrics: the ten depth metrics
ALIGN_RTOL = 1e-9  # ... least-squares (scale, shift), float64 lstsq in both
HDR_DEPTH_M_RTOL = 1e-6  # test_torch_data_prep: preprocess_frame's metric depth (rgb and mm within 1 level)


def _train_bounds(prefix: str, metrics=("loss",)) -> dict:
    out = {f"{prefix}{m}": ("rel", LOSS_RTOL) for m in metrics}
    out.update({f"{prefix}grad_norm": ("rel", LOSS_RTOL), f"{prefix}param_sums": ("sums", PARAM_ELEMENT)})
    return out


BOUNDS: Dict[str, Dict[str, tuple]] = {
    "marigold_single": {f"{t}_{s}": ("abs", DEVICE_BODY if t == "depth" else NORMALS) for t in ("depth", "normals")
                        for s in ("64", "72x56")},
    "marigold_multi": {"ddim_depth_members": ("abs", DEVICE_BODY), "ddim_normals_members": ("abs", NORMALS),
                       "lcm_depth": ("abs", DEVICE_BODY),
                       **{f"combine_{r}_{o}": ("abs", COMBINE) for r in ("median", "mean")
                          for o in ("depth", "uncertainty")}},
    "geowizard": {k: ("abs", DEVICE_BODY) for k in ("depth", "normals", "ens_depth_members", "ens_normal_members")},
    "train_sd2": {**_train_bounds("depth."), **_train_bounds("normals.")},
    "train_geowizard": _train_bounds("", ("loss", "loss_ssi", "loss_angular")),
    "eval_metrics": {"least_square.scale_shift": ("rtol", ALIGN_RTOL), "least_square.metrics": ("rtol", METRIC_RTOL),
                     "least_square_disparity.scale_shift": ("rtol", ALIGN_RTOL),
                     "least_square_disparity.metrics": ("rtol", METRIC_RTOL), "normal_metrics": ("equal", 0.0)},
    "data_prep": {"d2nt_basic": ("equal", 0.0), "d2nt_v2": ("equal", 0.0), "d2nt_v3": ("equal", 0.0),
                  "hypersim.rgb": ("abs", 1), "hypersim.depth_mm": ("abs", 1),
                  "hypersim.depth_m": ("rtol", HDR_DEPTH_M_RTOL)},
    "card_marigold": {"depth": ("abs", DEVICE_BODY), "normals": ("abs", NORMALS)},
    "card_geowizard": {"depth": ("abs", DEVICE_BODY), "normals": ("abs", DEVICE_BODY)},
    "card_train": _train_bounds("depth."),
}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def new_module(part: str, meta_config: Mapping[str, object]) -> torch.nn.Module:
    """The port's module of a golden part from its config in `meta`, on the meta device."""
    from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig
    from diffusion_e2e_ft_tpu_torch.models import clip

    cfg = R.config(meta_config)
    with torch.device("meta"):
        if part == "unet":
            return UNet2DCondition(UNetConfig(**cfg))
        if part == "vae":
            return AutoencoderKL(VAEConfig(**cfg))
        return clip.CLIPVisionModelWithProjection(clip.CLIPVisionConfig(**cfg))


def key_shapes(module: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def modules(g: R.Golden, device="cpu") -> Dict[str, torch.nn.Module]:
    """{part: the port's module}, fp32 on `device`, filled by the rule. The
    module's key set and shapes must be the JAX module's (the golden's)."""
    out = {}
    for part in g.meta["weights"]:
        module = new_module(part, g.meta[part])
        if key_shapes(module) != g.shapes(part):
            raise AssertionError(f"{g.name}/{part}: the port's state_dict keys or shapes differ from the JAX module's")
        module.load_state_dict(g.state_dict(part, device), strict=True, assign=True)
        out[part] = module.eval()
    return out


def rgb(image: np.ndarray, device="cpu") -> torch.Tensor:
    from diffusion_e2e_ft_tpu_torch.ops import image as im

    return im.normalize_rgb(torch.from_numpy(image).to(device))[None]


def nchw(x: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).to(device)


def numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# Runners: {stored output key: the port's array}
# ---------------------------------------------------------------------------


def marigold_pipeline(g: R.Golden, mods: dict, device="cpu", dtype=torch.float32, scheduler_type="ddim"):
    """A pipeline over `mods` (moved and cast in place)."""
    from diffusion_e2e_ft_tpu_torch.ops.scheduler import SchedulerConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    return MarigoldPipeline(mods["unet"], mods["vae"], SchedulerConfig(), g["empty_text_embed"], device=device,
                            dtype=dtype, scheduler_type=scheduler_type)


def geowizard_pipeline(mods: dict, device="cpu", dtype=torch.float32):
    from diffusion_e2e_ft_tpu_torch.ops.scheduler import SchedulerConfig
    from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline

    return GeoWizardPipeline(mods["unet"], mods["vae"], mods["image_encoder"], SchedulerConfig(), device=device,
                             dtype=dtype)


def single_step(g: R.Golden, pipe, suffixes=("",)) -> dict:
    """Marigold's device body at one step from zeros: `depth<s>`, `normals<s>` of `image<s>`."""
    out = {}
    for s in suffixes:
        x = rgb(g[f"image{s}"], pipe.device)
        for task in ("depth", "normals"):
            out[f"{task}{s}"] = numpy(pipe.infer(x, 1, task == "normals"))
    return out


def marigold_multi(g: R.Golden, mods: dict, device="cpu") -> dict:
    from diffusion_e2e_ft_tpu_torch.ops import ensemble as ens

    pipe = marigold_pipeline(g, mods, device)
    x, steps = rgb(g["image"], device), g.meta["steps"]
    latents = nchw(g["latent0"], device)
    out = {f"ddim_{task}_members": numpy(pipe.infer(x, steps, task == "normals", latents))
           for task in ("depth", "normals")}
    members = torch.from_numpy(g["ddim_depth_members"]).to(device)  # the op alone, on the reference's members
    for reduction in ("median", "mean"):
        depth, unc = ens.combine_depths(members, g["combine_s"], g["combine_t"], reduction)
        out[f"combine_{reduction}_depth"], out[f"combine_{reduction}_uncertainty"] = numpy(depth), numpy(unc)
    lcm = marigold_pipeline(g, mods, device, scheduler_type="lcm")
    noise = [nchw(n, device) for n in g["lcm_step_noise"]]
    out["lcm_depth"] = numpy(lcm.infer(x, g.meta["lcm_steps"], False, nchw(g["lcm_latent0"], device), noise))
    return out


def geowizard(g: R.Golden, pipe, ensemble: bool = True) -> dict:
    x = rgb(g["image"], pipe.device)
    depth, normals = pipe.infer(x, "indoor")
    out = {"depth": numpy(depth), "normals": numpy(normals)}
    if ensemble:
        depth, normals = pipe.infer(x, "outdoor", 2, nchw(g["latent0"], pipe.device))
        out.update(ens_depth_members=numpy(depth), ens_normal_members=numpy(normals))
    return out


def train_step(g: R.Golden, mods: dict, prefix: str, device="cpu", modality: Optional[str] = None) -> dict:
    """One `train_step` of the golden's config on its batch: the loss and
    metrics, the gradient norm and the per-leaf sums of the updated
    parameters (sorted HF keys). GeoWizard's joint trainer where the golden
    has an image tower. The UNet's parameters move."""
    from diffusion_e2e_ft_tpu_torch.training import E2ETrainer, GeoWizardTrainer, TrainConfig

    unet = mods["unet"].to(device)
    if "image_encoder" in mods:
        trainer = GeoWizardTrainer(TrainConfig(**g.meta["train_config"]), unet, mods["vae"].to(device),
                                   mods["image_encoder"].to(device))
    else:
        trainer = E2ETrainer(TrainConfig(modality=modality, **g.meta["train_config"]), unet, mods["vae"].to(device),
                             g["empty_text_embed"])
    batch = {k[len(prefix + "batch."):]: v for k, v in g.arrays.items() if k.startswith(prefix + "batch.")}
    state, metrics = trainer.train_step(trainer.init_state(), batch)
    if sorted(state.params) != sorted(g.shapes("unet")):
        raise AssertionError(f"{g.name}: the trained leaves are not the golden's")
    out = {f"{prefix}{k}": float(v) for k, v in metrics.items() if k != "lr_step"}
    out[f"{prefix}param_sums"] = R.digest(state.params)
    return out


def eval_metrics(g: R.Golden) -> dict:
    from diffusion_e2e_ft_tpu_torch.evaluation import alignment as align
    from diffusion_e2e_ft_tpu_torch.evaluation import metrics as M

    pred, gt, mask = g["pred"], g["gt"], g["mask"]
    lo, hi = g.meta["depth_range"]
    out = {}
    for alignment in ("least_square", "least_square_disparity"):
        if alignment == "least_square":
            aligned, scale, shift = align.align_depth_least_square(gt, pred, mask)
        else:
            gt_disp, nonneg = align.depth2disparity(gt, return_mask=True)
            aligned_disp, scale, shift = align.align_depth_least_square(gt_disp, pred, mask & nonneg)
            aligned = align.disparity2depth(aligned_disp)
        aligned = np.clip(np.clip(aligned, lo, hi), 1e-6, None)
        out[f"{alignment}.scale_shift"] = np.asarray([scale, shift], np.float64)
        out[f"{alignment}.metrics"] = np.asarray([M.DEPTH_METRIC_FUNCS[n](aligned, gt, mask)
                                                  for n in g.meta["depth_metrics"]], np.float64)
    errors = M.normal_angular_error_deg(g["normal_pred"], g["normal_gt"])[g["normal_mask"]]
    normal = M.normal_metrics(errors)
    assert list(normal) == g.meta["normal_metrics"]
    out["normal_metrics"] = np.asarray(list(normal.values()), np.float64)
    return out


def data_prep(g: R.Golden, device="cpu") -> dict:
    from diffusion_e2e_ft_tpu_torch.tools import depth_to_normal as d2n
    from diffusion_e2e_ft_tpu_torch.tools import hypersim_preprocess as hp

    out = {f"d2nt_{v}": d2n.depth_to_normal(g["d2nt_depth"], *d2n.VKITTI_INTRINSICS, v, device=device).cpu().numpy()
           for v in ("basic", "v2", "v3")}
    frame = hp.preprocess_frame(g["hypersim_rgb_hdr"], g["hypersim_distance"], g["hypersim_entity"], device=device)
    out.update({f"hypersim.{k}": v for k, v in frame.items()})
    return out


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def _max(err: np.ndarray, have: np.ndarray, want: np.ndarray) -> float:
    """The largest error, where equal values (NaN at the same place too) count 0."""
    same = (have == want) | (np.isnan(have) & np.isnan(want))
    return float(np.where(same, 0.0, np.nan_to_num(err, nan=np.inf)).max(initial=0.0))


@dataclasses.dataclass
class Row:
    key: str
    kind: str
    err: float  # max |d| ("abs", "equal"), relative ("rel", "rtol": the largest), max |d| / bound over the
    # leaves ("sums", whose bound is then 1)
    bound: float

    @property
    def ok(self) -> bool:
        return self.err <= self.bound

    def __str__(self) -> str:
        return f"{self.key} {self.kind} {self.err:.3e} (bound {self.bound:.3g}){'' if self.ok else ' FAIL'}"


def compare(g: R.Golden, got: Mapping[str, object], bounds: Mapping[str, tuple]) -> list:
    """A `Row` per bounded output; every key of `bounds` must be in `got`."""
    rows = []
    for key, (kind, bound) in bounds.items():
        want, have = np.asarray(g[key], np.float64), np.asarray(got[key], np.float64)
        if have.shape != want.shape:
            raise AssertionError(f"{g.name}/{key}: shape {have.shape}, the golden's {want.shape}")
        if kind == "sums":
            prefix = key[: -len("param_sums")]
            limit = R.leaf_sum_bounds(g[f"{prefix}param_count"], g[f"{prefix}param_max"], bound)
            rows.append(Row(key, kind, float((np.abs(have - want) / limit).max()), 1.0))
        elif kind == "rel":
            rows.append(Row(key, kind, float(abs(have - want) / abs(want)), bound))
        elif kind == "rtol":
            with np.errstate(divide="ignore", invalid="ignore"):
                rows.append(Row(key, kind, _max(np.abs(have - want) / np.abs(want), have, want), bound))
        else:
            rows.append(Row(key, kind, _max(np.abs(have - want), have, want), bound))
    return rows
