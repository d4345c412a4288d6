"""Writes the golden outputs: the JAX package's numbers on the weight rule of
`tests/_torch_golden.py`, as `tests/golden/<name>.npz`.

    python tests/golden/make_goldens.py                    # every golden
    python tests/golden/make_goldens.py marigold_single    # some of them
    python tests/golden/make_goldens.py --out /tmp/g card_train

It runs the JAX package on the CPU in fp32 with `jax_default_matmul_precision`
"highest" (as `tests/conftest.py` sets it), imports numpy, the JAX package and
the rule, and never the port. Each golden's weights come from the JAX
module's own `jax.eval_shape(init)` tree: its HF key set
(`models/convert.py::params_to_state_dict`, the vision tower through
`pipelines/loading.py::_clip_params_to_state_dict`) is drawn by the rule and
loaded back with `state_dict_to_params` / `clip_state_dict_to_params`, and
the tree must come back with the shapes `init` gives. Nothing is
downloaded: inputs are seeded synthetic arrays.

Two sets. Tier-1's run at tiny widths in `tests/test_torch_golden.py` on
the CPU, every path: Marigold single and multi-step, GeoWizard, the SD2 and
GeoWizard E2E train steps, the evaluation metrics, D2NT and the Hypersim
frame. The card's (`card_*`) keep the published widths and head dims so the
port's kernels run at their shapes in `chip_smoke.py`'s phase 20; the UNets
(and the vision tower) are cut in depth, because this generator runs on a
CPU that is not to run a full-size model; `meta["reduced"]` says what.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
for _path in (os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))):  # tests/ (the rule), the repo
    if _path not in sys.path:
        sys.path.insert(0, _path)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_golden as R  # noqa: E402
from diffusion_e2e_ft_tpu.evaluation import alignment as jalign  # noqa: E402
from diffusion_e2e_ft_tpu.evaluation import metrics as jm  # noqa: E402
from diffusion_e2e_ft_tpu.models import AutoencoderKL, UNet2DCondition, UNetConfig, VAEConfig  # noqa: E402
from diffusion_e2e_ft_tpu.models import clip as jclip  # noqa: E402
from diffusion_e2e_ft_tpu.models import convert as jconvert  # noqa: E402
from diffusion_e2e_ft_tpu.ops import ensemble as jens  # noqa: E402
from diffusion_e2e_ft_tpu.ops import image as jim  # noqa: E402
from diffusion_e2e_ft_tpu.ops import noise as jnoise  # noqa: E402
from diffusion_e2e_ft_tpu.ops import scheduler as jsched  # noqa: E402
from diffusion_e2e_ft_tpu.pipelines import loading as jloading  # noqa: E402
from diffusion_e2e_ft_tpu.pipelines.geowizard import GeoWizardPipeline, domain_one_hot  # noqa: E402
from diffusion_e2e_ft_tpu.pipelines.marigold import MarigoldPipeline  # noqa: E402
from diffusion_e2e_ft_tpu.tools import depth_to_normal as jd2n  # noqa: E402
from diffusion_e2e_ft_tpu.tools import hypersim_preprocess as jhp  # noqa: E402
from diffusion_e2e_ft_tpu.training import E2ETrainer, GeoWizardTrainer, TrainConfig  # noqa: E402

# Tier-1 models: the tiny configs of the existing parity tests
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, norm_num_groups=4)
TWO_LEVEL_UNET = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
                      layers_per_block=1)
TWO_LEVEL_VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
TINY_VISION = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, image_size=224, patch_size=32,
                   projection_dim=32)
# the card's: published widths and head dims, UNet depth cut to one ResNet / transformer block a level
# (two up-path blocks), the vision tower to 4 of its 24 layers
CARD_UNET = dict(layers_per_block=1)
CARD_VISION = dict(num_layers=4)
CARD_REDUCED = ("UNet layers_per_block 2 -> 1 (widths, heads and head dims as published): the goldens are "
                "written by the JAX package on a CPU, which is not to run a full-size model")
TINY_REDUCED = "tiny widths (the existing CPU parity tests' configs)"

TRAIN = dict(gradient_accumulation_steps=1, lr_warmup_steps=0, learning_rate=1e-3, adam_epsilon=1e-3)
SEED = 7  # the noise keys
MULTI_STEPS, MEMBERS, LCM_STEPS = 3, 3, 2
NYU_DEPTH_RANGE = (1e-3, 10.0)  # the eval golden clips aligned depth to NYU's range, as depth_bench does


def configure() -> None:
    """CPU, fp32 to the bit: the settings of tests/conftest.py."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")


def config_meta(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def part(module, seed: int, *init_args, vision: bool = False):
    """(meta entry, digest, flax params) of `module` filled by the rule."""
    tree = jax.eval_shape(module.init, jax.random.key(0), *init_args)["params"]
    views = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)
    sd = jloading._clip_params_to_state_dict(views, "vision") if vision else jconvert.params_to_state_dict(views)
    shapes = {k: list(v.shape) for k, v in sd.items()}
    weights = R.golden_weights(shapes, seed)
    params = (jconvert.clip_state_dict_to_params if vision else jconvert.state_dict_to_params)(weights)
    want = jax.tree_util.tree_structure(tree)
    assert jax.tree_util.tree_structure(params) == want, "the rule's key set does not rebuild the init tree"
    for (path, got), exp in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree_util.tree_leaves(tree)):
        assert got.shape == exp.shape, (jax.tree_util.keystr(path), got.shape, exp.shape)
    return {"seed": seed, "shapes": shapes}, R.digest(weights), params


def unet_part(cfg: UNetConfig, seed: int):
    args = [jnp.ones((1, 8, 8, cfg.in_channels)), jnp.asarray(999), jnp.ones((1, 2, cfg.cross_attention_dim))]
    if cfg.class_embed_proj_dim:
        args = [jnp.ones((2, 8, 8, cfg.in_channels)), jnp.asarray(999), jnp.ones((2, 1, cfg.cross_attention_dim)),
                jnp.ones((2, cfg.class_embed_proj_dim))]
    return part(UNet2DCondition(cfg), seed, *args)


def vae_part(cfg: VAEConfig, seed: int):
    return part(AutoencoderKL(cfg), seed, jnp.ones((1, 32, 32, 3)))


def vision_part(cfg, seed: int):
    return part(jclip.CLIPVisionModelWithProjection(cfg), seed, jnp.ones((1, cfg.image_size, cfg.image_size, 3)),
                vision=True)


def models(parts: dict) -> tuple:
    """{name: (meta, digest, params)} -> (meta weights, digests, params), each by name."""
    return tuple({n: p[i] for n, p in parts.items()} for i in range(3))


def image(seed: int, hw) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), dtype=np.uint8)


def rgb_of(img: np.ndarray) -> jnp.ndarray:
    return jim.normalize_rgb(jnp.asarray(img, jnp.float32))[None]


def leaf_stats(state_dict: dict) -> dict:
    """Per leaf, sorted key order: element count and max |value|."""
    keys = sorted(state_dict)
    return {"count": np.asarray([np.asarray(state_dict[k]).size for k in keys], np.int64),
            "max": np.asarray([float(np.abs(np.asarray(state_dict[k])).max()) for k in keys], np.float64)}


# ---------------------------------------------------------------------------
# Marigold
# ---------------------------------------------------------------------------


def marigold_pipeline(ucfg, vcfg, seeds, empty, scheduler_type="ddim"):
    parts = {"unet": unet_part(ucfg, seeds[0]), "vae": vae_part(vcfg, seeds[1])}
    weights, digests, params = models(parts)
    pipe = MarigoldPipeline(UNet2DCondition(ucfg), AutoencoderKL(vcfg), params["unet"], params["vae"],
                            jsched.SchedulerConfig(), empty, scheduler_type=scheduler_type)
    return pipe, weights, digests


def single_step(pipe, img: np.ndarray) -> dict:
    """`_infer_body` at one step from a zeros latent: depth and normals."""
    rgb = rgb_of(img)
    latent = jnp.zeros((1, img.shape[0] // 8, img.shape[1] // 8, 4))
    return {task: np.asarray(pipe._infer_jit(pipe.params, rgb, 1, task == "normals", latent, jax.random.key(0)))
            for task in ("depth", "normals")}


SINGLE_SIZES = {"64": (64, 64), "72x56": (72, 56)}  # a ragged one: latent 9 x 7


def marigold_single(sizes=tuple(SINGLE_SIZES)) -> tuple:
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig(**TINY_VAE)
    empty = np.random.default_rng(2).standard_normal((1, 2, ucfg.cross_attention_dim)).astype(np.float32)
    pipe, weights, digests = marigold_pipeline(ucfg, vcfg, (0, 1), empty)
    arrays = {"empty_text_embed": empty}
    for name in sizes:
        img = image(3, SINGLE_SIZES[name])
        arrays[f"image_{name}"] = img
        out = single_step(pipe, img)
        arrays[f"depth_{name}"], arrays[f"normals_{name}"] = out["depth"], out["normals"]
    meta = {"path": "marigold single step: _infer_body, trailing DDIM, zeros noise",
            "unet": config_meta(ucfg), "vae": config_meta(vcfg), "weights": weights, "reduced": TINY_REDUCED,
            "input_seeds": {"empty_text_embed": 2, "images": 3}}
    return meta, digests, arrays


def pyramid_latents(seed: int, members: int, shape) -> np.ndarray:
    """A JAX `__call__`'s member latents: `make_noise(pyramid, split(key(seed), E + 1)[1 + m], shape)`."""
    keys = jax.random.split(jax.random.key(seed), members + 1)[1:]
    return np.concatenate([np.asarray(jnoise.make_noise("pyramid", k, shape, jnp.float32)) for k in keys])


def fixed_alignment(members: np.ndarray, s: np.ndarray, t: np.ndarray, reduction: str) -> tuple:
    """The JAX `ensemble_depths` with its BFGS result replaced by (s, t): its combine step."""
    import scipy.optimize

    minimize = scipy.optimize.minimize
    scipy.optimize.minimize = lambda *a, **k: scipy.optimize.OptimizeResult(x=np.concatenate([s, t]))
    try:
        return jens.ensemble_depths(members, reduction=reduction)
    finally:
        scipy.optimize.minimize = minimize


def marigold_multi() -> tuple:
    ucfg, vcfg = UNetConfig.tiny(), VAEConfig(**TINY_VAE)
    empty = np.random.default_rng(2).standard_normal((1, 2, ucfg.cross_attention_dim)).astype(np.float32)
    pipe, weights, digests = marigold_pipeline(ucfg, vcfg, (0, 1), empty)
    img = image(4, (64, 48))
    shape = (1, 8, 6, 4)
    latents = pyramid_latents(SEED, MEMBERS, shape)
    rgb = jnp.broadcast_to(rgb_of(img), (MEMBERS, 64, 48, 3))
    arrays = {"empty_text_embed": empty, "image": img, "latent0": latents}
    for task in ("depth", "normals"):
        arrays[f"ddim_{task}_members"] = np.asarray(pipe._infer_jit(
            pipe.params, rgb, MULTI_STEPS, task == "normals", jnp.asarray(latents), jax.random.fold_in(
                jax.random.key(SEED), 0)))
    members = arrays["ddim_depth_members"]
    flat = members.reshape(MEMBERS, -1)
    rng = np.random.default_rng(5)
    s = (rng.uniform(0.8, 1.2, MEMBERS) / (flat.max(1) - flat.min(1))).astype(np.float32)
    t = (-s * flat.min(1) + rng.uniform(-0.1, 0.1, MEMBERS)).astype(np.float32)
    arrays.update(combine_s=s, combine_t=t)
    for reduction in ("median", "mean"):
        arrays[f"combine_{reduction}_depth"], arrays[f"combine_{reduction}_uncertainty"] = fixed_alignment(
            members, s, t, reduction)
    lcm = MarigoldPipeline(pipe.unet, pipe.vae, pipe.params["unet"], pipe.params["vae"], jsched.SchedulerConfig(),
                           empty, scheduler_type="lcm")
    key = jax.random.fold_in(jax.random.key(SEED + 1), 0)
    latent0 = np.asarray(jnoise.make_noise("gaussian", jax.random.key(SEED + 2), shape, jnp.float32))
    arrays["lcm_latent0"] = latent0
    arrays["lcm_step_noise"] = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                                         for k in jax.random.split(key, LCM_STEPS)])
    arrays["lcm_depth"] = np.asarray(lcm._infer_jit(lcm.params, rgb_of(img), LCM_STEPS, False, jnp.asarray(latent0),
                                                    key))
    meta = {"path": f"marigold multi-step: {MULTI_STEPS} trailing DDIM steps, {MEMBERS} pyramid-noise members "
                    f"(the JAX draws stored), combine at a stored (s, t), {LCM_STEPS} LCM steps (step noise stored)",
            "unet": config_meta(ucfg), "vae": config_meta(vcfg), "weights": weights, "reduced": TINY_REDUCED,
            "steps": MULTI_STEPS, "lcm_steps": LCM_STEPS,
            "input_seeds": {"empty_text_embed": 2, "image": 4, "pyramid_keys": SEED, "combine_s_t": 5,
                            "lcm_step_keys": SEED + 1, "lcm_latent_key": SEED + 2}}
    return meta, digests, arrays


# ---------------------------------------------------------------------------
# GeoWizard
# ---------------------------------------------------------------------------


def geowizard_pipeline(ucfg, vcfg, viscfg, seeds):
    parts = {"unet": unet_part(ucfg, seeds[0]), "vae": vae_part(vcfg, seeds[1]),
             "image_encoder": vision_part(viscfg, seeds[2])}
    weights, digests, params = models(parts)
    pipe = GeoWizardPipeline(UNet2DCondition(ucfg), AutoencoderKL(vcfg), jclip.CLIPVisionModelWithProjection(viscfg),
                             params["unet"], params["vae"], params["image_encoder"], jsched.SchedulerConfig())
    return pipe, weights, digests


def geowizard_meta(ucfg, vcfg, viscfg, weights, reduced, **extra) -> dict:
    return {"unet": config_meta(ucfg), "vae": config_meta(vcfg), "image_encoder": config_meta(viscfg),
            "weights": weights, "reduced": reduced, **extra}


def geowizard() -> tuple:
    ucfg = UNetConfig.geowizard(**TWO_LEVEL_UNET, cross_attention_dim=32)
    vcfg, viscfg = VAEConfig(**TINY_VAE), jclip.CLIPVisionConfig(**TINY_VISION)
    pipe, weights, digests = geowizard_pipeline(ucfg, vcfg, viscfg, (10, 11, 12))
    img = image(13, (64, 48))
    rgb = rgb_of(img)
    arrays = {"image": img}
    arrays["depth"], arrays["normals"] = (np.asarray(x) for x in pipe._infer_jit(
        pipe.params, rgb, 1, jnp.zeros((1, 8, 6, 4)), jnp.asarray(domain_one_hot("indoor"))))
    latents = pyramid_latents(SEED + 3, 2, (1, 8, 6, 4))
    arrays["latent0"] = latents
    arrays["ens_depth_members"], arrays["ens_normal_members"] = (np.asarray(x) for x in pipe._infer_jit(
        pipe.params, jnp.broadcast_to(rgb, (2, 64, 48, 3)), 2, jnp.asarray(latents),
        jnp.asarray(domain_one_hot("outdoor"))))
    meta = geowizard_meta(ucfg, vcfg, viscfg, weights, TINY_REDUCED, input_seeds={"image": 13, "pyramid_keys": SEED + 3},
                          path="geowizard joint: one step (indoor), and a 2-step ensemble of 2 pyramid members "
                               "(outdoor); _infer_body with the domain switcher")
    return meta, digests, arrays


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def sd2_batch(modality: str, seed: int, b: int, h: int, w: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"rgb": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32), "val_mask": rng.random((b, h, w)) > 0.2}
    if modality == "depth":
        batch["target"] = rng.uniform(-1, 1, (b, h, w)).astype(np.float32)
    else:
        n = rng.normal(size=(b, h, w, 3)).astype(np.float32)
        batch["target"] = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return batch


def adam_first_moments(opt_state) -> dict:
    """{HF key: Adam's first moment} over every LR group (a group's masked leaves hold none)."""
    import optax

    out = {}
    for node in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(node, optax.ScaleByAdamState):
            tree = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(node.mu)[0]:
                sub = tree
                for p in path[:-1]:
                    sub = sub.setdefault(p.key, {})
                sub[path[-1].key] = np.asarray(leaf)
            out.update(jconvert.params_to_state_dict(tree))
    return out


def step_outputs(trainer, params, batch: dict, prefix: str) -> dict:
    """One `train_step` from `params`: the loss and metrics, the raw gradient's
    global norm, each leaf's clipped-gradient max |g| (from Adam's first
    moment after one step, (1 - b1) g), and per leaf (sorted HF keys) the sum
    and sum of squares, count and max |p| of the parameters after the update."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state, metrics = trainer.train_step(trainer.init_state(jax.tree.map(jnp.copy, params)), jbatch,
                                        jax.random.key(0))  # the step donates its state
    updated = jconvert.params_to_state_dict(jax.tree.map(np.asarray, state.params))
    mu = adam_first_moments(state.opt_state)
    assert sorted(mu) == sorted(updated)
    stats = leaf_stats(updated)
    out = {f"{prefix}{k}": np.float64(v) for k, v in metrics.items() if k != "lr_step"}
    out.update({f"{prefix}param_sums": R.digest(updated), f"{prefix}param_count": stats["count"],
                f"{prefix}param_max": stats["max"],
                f"{prefix}grad_max": leaf_stats(mu)["max"] / (1.0 - trainer.config.adam_beta1)})
    return out


def train_sd2(ucfg=None, vcfg=None, hw=(48, 64), b=2, modalities=("depth", "normals"), seeds=(20, 21),
              reduced=TINY_REDUCED, tokens=2) -> tuple:
    ucfg = ucfg or UNetConfig.tiny(**TWO_LEVEL_UNET)
    vcfg = vcfg or VAEConfig(**TWO_LEVEL_VAE)
    parts = {"unet": unet_part(ucfg, seeds[0]), "vae": vae_part(vcfg, seeds[1])}
    weights, digests, params = models(parts)
    empty = np.random.default_rng(seeds[0] + 2).standard_normal((1, tokens, ucfg.cross_attention_dim)).astype(
        np.float32)
    arrays = {"empty_text_embed": empty}
    for i, modality in enumerate(modalities):
        batch = sd2_batch(modality, 3 + i, b, *hw)
        arrays.update({f"{modality}.batch.{k}": v for k, v in batch.items()})
        cfg = TrainConfig(modality=modality, **TRAIN)
        trainer = E2ETrainer(cfg, UNet2DCondition(ucfg), AutoencoderKL(vcfg), params["vae"], empty)
        arrays.update(step_outputs(trainer, params["unet"], batch, f"{modality}."))
    meta = {"path": "SD2 E2E train step (training/trainer.py train_step): zeros noise, t=999, fused VAE config, "
                    "UNet checkpointing, clip 1.0, AdamW", "train_config": TRAIN,
            "modalities": list(modalities), "unet": config_meta(ucfg), "vae": config_meta(vcfg), "weights": weights,
            "reduced": reduced, "input_seeds": {"empty_text_embed": seeds[0] + 2,
                                                **{f"{m}.batch": 3 + i for i, m in enumerate(modalities)}}}
    return meta, digests, arrays


def joint_batch(seed: int, b: int, h: int, w: int) -> dict:
    """Unit normals, depth in [-1, 1], a domain, and a mask with an invalid block."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    mask = np.ones((b, h, w), bool)
    mask[0, : h // 3, : w // 3] = False
    mask[-1, h // 2:, (5 * w) // 8:] = rng.random((h - h // 2, w - (5 * w) // 8)) > 0.3
    return {"rgb": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "depth_target": rng.uniform(-1, 1, (b, h, w)).astype(np.float32),
            "normal_target": n / np.linalg.norm(n, axis=-1, keepdims=True), "val_mask": mask,
            "domain": np.array([0.0, 1.0, 0.0], np.float32)}


def train_geowizard() -> tuple:
    ucfg = UNetConfig.geowizard(**TWO_LEVEL_UNET, cross_attention_dim=32)
    vcfg, viscfg = VAEConfig(**TINY_VAE), jclip.CLIPVisionConfig(**TINY_VISION)
    parts = {"unet": unet_part(ucfg, 30), "vae": vae_part(vcfg, 31), "image_encoder": vision_part(viscfg, 32)}
    weights, digests, params = models(parts)
    batch = joint_batch(33, 2, 48, 64)
    trainer = GeoWizardTrainer(TrainConfig(**TRAIN), UNet2DCondition(ucfg), AutoencoderKL(vcfg), params["vae"],
                               jclip.CLIPVisionModelWithProjection(viscfg), params["image_encoder"])
    arrays = {f"batch.{k}": v for k, v in batch.items()}
    arrays.update(step_outputs(trainer, params["unet"], batch, ""))
    meta = geowizard_meta(ucfg, vcfg, viscfg, weights, TINY_REDUCED, train_config=TRAIN, input_seeds={"batch": 33},
                          path="GeoWizard E2E joint train step (training/geowizard.py): zeros noise, t=999, "
                               "SSI + angular loss, the class embedding's 10x LR group")
    return meta, digests, arrays


# ---------------------------------------------------------------------------
# Evaluation and data preparation
# ---------------------------------------------------------------------------


def eval_metrics() -> tuple:
    """The ten depth metrics after each least-squares alignment (depth_bench's
    steps: align, clip to the dataset's range, then away from 0) and the normal
    metrics, on Marigold single-step predictions against synthetic GT."""
    single = marigold_single()[2]
    pred, normals = single["depth_64"][0], single["normals_64"][0]
    rng = np.random.default_rng(40)
    yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64), indexing="ij")
    gt = (1.0 + 8.0 * (0.6 * yy + 0.35 * xx + 0.05 * np.sin(20 * xx))).astype(np.float32)
    gt[rng.random(gt.shape) < 0.1] = 0.0
    mask = (gt > NYU_DEPTH_RANGE[0]) & (gt < NYU_DEPTH_RANGE[1])
    arrays = {"pred": pred, "gt": gt, "mask": mask}
    for alignment in ("least_square", "least_square_disparity"):
        if alignment == "least_square":
            aligned, scale, shift = jalign.align_depth_least_square(gt, pred, mask)
        else:
            gt_disp, nonneg = jalign.depth2disparity(gt, return_mask=True)
            aligned_disp, scale, shift = jalign.align_depth_least_square(gt_disp, pred, mask & nonneg)
            aligned = jalign.disparity2depth(aligned_disp)
        aligned = np.clip(np.clip(aligned, *NYU_DEPTH_RANGE), 1e-6, None)
        arrays[f"{alignment}.scale_shift"] = np.asarray([scale, shift], np.float64)
        arrays[f"{alignment}.metrics"] = np.asarray([jm.DEPTH_METRIC_FUNCS[n](aligned, gt, mask)
                                                     for n in jm.DEPTH_METRIC_FUNCS], np.float64)
    n = rng.normal(size=(64, 64, 3)).astype(np.float32)
    normal_gt = n / np.linalg.norm(n, axis=-1, keepdims=True)
    normal_mask = rng.random((64, 64)) > 0.2
    errors = jm.normal_angular_error_deg(normals, normal_gt)[normal_mask]
    normal = jm.normal_metrics(errors)
    arrays.update(normal_pred=normals, normal_gt=normal_gt, normal_mask=normal_mask,
                  normal_metrics=np.asarray(list(normal.values()), np.float64))
    meta = {"path": "evaluation: least-squares alignment (depth, disparity) + the ten depth metrics; the normal "
                    "metrics", "depth_metrics": list(jm.DEPTH_METRIC_FUNCS), "normal_metrics": list(normal),
            "depth_range": list(NYU_DEPTH_RANGE), "weights": {},
            "input_seeds": {"gt_and_masks": 40, "predictions": "marigold_single's depth_64 and normals_64"}}
    return meta, {}, arrays


def data_prep() -> tuple:
    rng = np.random.default_rng(50)
    depth = rng.integers(100, 8000, (64, 96)).astype(np.float64)
    arrays = {"d2nt_depth": depth}
    for version in ("basic", "v2", "v3"):
        arrays[f"d2nt_{version}"] = jd2n.depth_to_normal(depth, *jd2n.VKITTI_INTRINSICS, version)
    h, w = 48, 64
    rgb = rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
    distance = rng.uniform(0.5, 40.0, (h, w)).astype(np.float32)
    distance[0, :3] = np.nan  # no hit
    distance[1, :3] = 90.0  # beyond 65.535 m: saturates
    entity = rng.integers(-1, 20, (h, w)).astype(np.int32)
    arrays.update(hypersim_rgb_hdr=rgb, hypersim_distance=distance, hypersim_entity=entity)
    with np.errstate(invalid="ignore"):
        out = jhp.preprocess_frame(rgb, distance, entity)
    arrays.update({f"hypersim.{k}": v for k, v in out.items()})
    meta = {"path": "data preparation: D2NT (basic, v2, v3 with the MRF) on a 64x96 depth frame with VKITTI2's "
                    "intrinsics; Hypersim preprocess_frame on a 48x64 HDR frame", "weights": {},
            "input_seeds": {"frames": 50}}
    return meta, {}, arrays


# ---------------------------------------------------------------------------
# The card's set: published widths and head dims at 256x256
# ---------------------------------------------------------------------------

CARD_HW = (256, 256)


def card_marigold() -> tuple:
    ucfg, vcfg = UNetConfig.sd2(**CARD_UNET), VAEConfig()
    empty = np.random.default_rng(62).standard_normal((1, 77, ucfg.cross_attention_dim)).astype(np.float32)
    pipe, weights, digests = marigold_pipeline(ucfg, vcfg, (60, 61), empty)
    img = image(63, CARD_HW)
    out = single_step(pipe, img)
    arrays = {"empty_text_embed": empty, "image": img, "depth": out["depth"], "normals": out["normals"]}
    meta = {"path": "marigold single step at SD2 width, 256x256 (chip_smoke phase 5's shapes)",
            "unet": config_meta(ucfg), "vae": config_meta(vcfg), "weights": weights, "reduced": CARD_REDUCED,
            "input_seeds": {"empty_text_embed": 62, "image": 63}}
    return meta, digests, arrays


def card_geowizard() -> tuple:
    ucfg, vcfg = UNetConfig.geowizard(**CARD_UNET), VAEConfig()
    viscfg = jclip.CLIPVisionConfig(**CARD_VISION)
    pipe, weights, digests = geowizard_pipeline(ucfg, vcfg, viscfg, (70, 71, 72))
    img = image(73, CARD_HW)
    depth, normals = pipe._infer_jit(pipe.params, rgb_of(img), 1, jnp.zeros((1, 32, 32, 4)),
                                     jnp.asarray(domain_one_hot("indoor")))
    meta = geowizard_meta(ucfg, vcfg, viscfg, weights, CARD_REDUCED + "; the vision tower 24 -> 4 layers",
                          input_seeds={"image": 73},
                          path="geowizard joint single step at SD1.5 / CLIP ViT-L/14 width, 256x256, indoor")
    return meta, digests, {"image": img, "depth": np.asarray(depth), "normals": np.asarray(normals)}


def card_train() -> tuple:
    """The SD2 depth step at batch 1, 256x256, on the card Marigold's weights and text context."""
    return train_sd2(UNetConfig.sd2(**CARD_UNET), VAEConfig(), CARD_HW, 1, ("depth",), (60, 61), CARD_REDUCED,
                     tokens=77)


TIER1 = {"marigold_single": marigold_single, "marigold_multi": marigold_multi, "geowizard": geowizard,
         "train_sd2": train_sd2, "train_geowizard": train_geowizard, "eval_metrics": eval_metrics,
         "data_prep": data_prep}
CARD = {"card_marigold": card_marigold, "card_geowizard": card_geowizard, "card_train": card_train}
GOLDENS = {**TIER1, **CARD}
# the depth outputs ([0, 1], clipped) whose share of values inside (0, 1) each golden records
DEPTH_OUTPUTS = {"marigold_single": ("depth_64", "depth_72x56"),
                 "marigold_multi": ("ddim_depth_members", "lcm_depth"), "geowizard": ("depth", "ens_depth_members"),
                 "card_marigold": ("depth",), "card_geowizard": ("depth",)}


def build(name: str, **kw) -> tuple:
    """(meta, digests, arrays) of golden `name` (`kw` to its builder), with
    the depth outputs' share of values inside (0, 1) in meta."""
    meta, digests, arrays = GOLDENS[name](**kw)
    inside = {k: R.inside_share(arrays[k]) for k in DEPTH_OUTPUTS.get(name, ()) if k in arrays}
    hw = {tuple(v.shape[-3:-1]) for k, v in arrays.items() if k.split(".")[-1] in ("rgb", "image") or
          k.startswith("image_")}
    meta.update(name=name, numpy=np.__version__, jax=jax.__version__, inside=inside, image_hw=sorted(hw))
    return meta, digests, arrays


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", help=f"of {', '.join(GOLDENS)} (default: all)")
    p.add_argument("--out", default=R.GOLDEN_DIR)
    args = p.parse_args(argv)
    unknown = set(args.names) - set(GOLDENS)
    if unknown:
        p.error(f"unknown goldens {sorted(unknown)}")
    configure()
    os.makedirs(args.out, exist_ok=True)
    for name in args.names or list(GOLDENS):
        t0 = time.perf_counter()
        meta, digests, arrays = build(name)
        path = os.path.join(args.out, f"{name}.npz")
        R.save_golden(path, meta, digests, arrays)
        print(f"{name}: {os.path.getsize(path)} bytes, {time.perf_counter() - t0:.1f} s, inside (0, 1): "
              f"{meta['inside']}", flush=True)


if __name__ == "__main__":
    main()
