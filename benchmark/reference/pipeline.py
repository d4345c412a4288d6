"""The plain math around the models: a served request and a training
micro-step, for Marigold (depth from one pass of an SD2 UNet between a VAE
encode and decode) and GeoWizard (depth and normals from a joint SD1.5 UNet
on a CLIP image embedding), written from the papers and the published
pipelines in plain torch, float32.

Served request: resize so the long side is the processing resolution
(antialiased; Marigold bilinear), map to [-1, 1], VAE encode (the mean,
x 0.18215), the UNet at t = 999 on [image latent; zeros], the trailing-DDIM
x0 of a v-prediction, VAE decode; depth = the channel mean clipped to
[-1, 1] and mapped to [0, 1], min-max normalised, resized back to the input
(GeoWizard: bicubic for depth, nearest for normals; normals unit, sign
flipped). Training micro-step: the same forward at t = 999 on the batch,
the decode inside the graph, the scale-and-shift-invariant L1 on depth and
the angular loss on normals, means over every valid pixel of the batch.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

LATENT_SCALE = 0.18215
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DOMAINS = ("indoor", "outdoor", "object")


def alpha_bar(sched: dict, t: int) -> float:
    """alphas_cumprod[t] of the scaled-linear schedule, as diffusers computes it."""
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(f"unsupported beta schedule {sched['beta_schedule']!r}")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, sched["num_train_timesteps"],
                        dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas.astype(np.float32).astype(np.float64)).astype(np.float32)
    return float(acp[t])


def x0_from_v(sched: dict, sample: torch.Tensor, v: torch.Tensor, t: int) -> torch.Tensor:
    if sched["prediction_type"] != "v_prediction":
        raise ValueError(f"unsupported prediction type {sched['prediction_type']!r}")
    a = alpha_bar(sched, t)
    return math.sqrt(a) * sample - math.sqrt(1.0 - a) * v


def resize(x: torch.Tensor, hw, mode: str) -> torch.Tensor:
    """NHWC resize; antialiased except nearest (half-pixel centres)."""
    y = x.permute(0, 3, 1, 2)
    if mode == "nearest":
        y = F.interpolate(y, size=tuple(hw), mode="nearest-exact")
    else:
        y = F.interpolate(y, size=tuple(hw), mode=mode, antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1)


def processing_hw(h: int, w: int, res: int):
    f = min(res / w, res / h)
    return int(h * f), int(w * f)


def prepare(image: np.ndarray, res: int, device) -> torch.Tensor:
    """uint8 [H, W, 3] -> [1, h, w, 3] in [-1, 1] at the processing resolution."""
    x = torch.from_numpy(image.astype(np.float32)).to(device)[None]
    x = resize(x, processing_hw(image.shape[0], image.shape[1], res), "bilinear")
    return x / 255.0 * 2.0 - 1.0


def clip_pixels(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, 3] in [-1, 1] -> CLIP pixels [B, 3, size, size]: bicubic, CLIP mean and std."""
    x = F.interpolate(((rgb + 1.0) / 2.0).permute(0, 3, 1, 2), size=(size, size), mode="bicubic",
                      antialias=True, align_corners=False)
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return (x - mean) / std


def switcher(domain: str, batch: int, device) -> torch.Tensor:
    """GeoWizard's [2B, 10] class vector: sin, cos of the task one-hot ([0, 1] depth,
    [1, 0] normals) then of the domain one-hot."""
    geo = torch.tensor([[0.0, 1.0], [1.0, 0.0]], device=device).repeat_interleave(batch, dim=0)
    dom = torch.zeros(1, 3, device=device)
    dom[0, DOMAINS.index(domain)] = 1.0
    dom = dom.expand(2 * batch, 3)
    return torch.cat([torch.sin(geo), torch.cos(geo), torch.sin(dom), torch.cos(dom)], dim=-1)


def depth_from_decoded(decoded: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] -> [B, H, W] in [0, 1]."""
    return (decoded.float().mean(dim=1).clamp(-1.0, 1.0) + 1.0) / 2.0


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + 1e-5)


def minmax(d: torch.Tensor) -> torch.Tensor:
    return (d - d.min()) / (d.max() - d.min()).clamp_min(1e-8)


# ----------------------------------------------------------------------------- serving


def marigold_depth(m, sched: dict, context: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """[1, h, w, 3] in [-1, 1] -> depth [h, w] in [0, 1] (before min-max)."""
    lat = m.vae.encode_mean(rgb.permute(0, 3, 1, 2)) * LATENT_SCALE
    noisy = torch.zeros_like(lat)
    t = sched["num_train_timesteps"] - 1
    v = m.unet(torch.cat([lat, noisy], dim=1), t, context)
    return depth_from_decoded(m.vae.decode(x0_from_v(sched, noisy, v, t) / LATENT_SCALE))[0]


def marigold_request(m, sched: dict, context, image: np.ndarray, res: int) -> Dict[str, np.ndarray]:
    rgb = prepare(image, res, context.device)
    d = minmax(marigold_depth(m, sched, context, rgb))
    if tuple(d.shape) != image.shape[:2]:
        d = resize(d[None, ..., None], image.shape[:2], "bilinear")[0, ..., 0]
    return {"depth": d.clamp(0.0, 1.0).cpu().numpy()}


def geowizard_pair(m, sched: dict, rgb: torch.Tensor, domain: str):
    """[1, h, w, 3] -> (depth [h, w] in [0, 1], unit normals [h, w, 3], GeoWizard's sign)."""
    lat = m.vae.encode_mean(rgb.permute(0, 3, 1, 2)) * LATENT_SCALE
    lat2 = torch.cat([lat, lat])
    embed = m.image_encoder(clip_pixels(rgb, m.clip_size))[:, None, :]
    context = torch.cat([embed, embed])
    noisy = torch.zeros_like(lat2)
    t = sched["num_train_timesteps"] - 1
    v = m.unet(torch.cat([lat2, noisy], dim=1), t, context, switcher(domain, 1, rgb.device))
    decoded = m.vae.decode(x0_from_v(sched, noisy, v, t) / LATENT_SCALE)
    depth = depth_from_decoded(decoded[:1])[0]
    normal = -unit(decoded[1].float().permute(1, 2, 0))
    return depth, normal


def geowizard_request(m, sched: dict, image: np.ndarray, res: int, domain: str) -> Dict[str, np.ndarray]:
    rgb = prepare(image, res, next(m.unet.parameters()).device)
    d, n = geowizard_pair(m, sched, rgb, domain)
    d = minmax(d)
    if tuple(d.shape) != image.shape[:2]:
        d = resize(d[None, ..., None], image.shape[:2], "bicubic")[0, ..., 0]
        n = resize(n[None], image.shape[:2], "nearest")[0]
    return {"depth": d.clamp(0.0, 1.0).cpu().numpy(), "normal": n.clamp(-1.0, 1.0).cpu().numpy()}


# ----------------------------------------------------------------------------- training


def ssi_abs_sum(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over valid pixels of |s p + t - y|, with (s, t) the least-squares fit of
    each image (0, 0 where its 2x2 system is singular)."""
    p, y, m = pred.float(), target.float(), mask.float()
    a00, a01, a11 = (m * p * p).sum((1, 2)), (m * p).sum((1, 2)), m.sum((1, 2))
    b0, b1 = (m * p * y).sum((1, 2)), (m * y).sum((1, 2))
    det = a00 * a11 - a01 * a01
    ok = det > 0
    safe = torch.where(ok, det, torch.ones_like(det))
    s = torch.where(ok, (a11 * b0 - a01 * b1) / safe, torch.zeros_like(det))
    sh = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, torch.zeros_like(det))
    return ((s[:, None, None] * p + sh[:, None, None] - y).abs() * m).sum()


def angular_sum(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum over valid pixels of the angle between unit normals, in radians."""
    dot = (pred.float() * target.float()).sum(-1).clamp(-1.0, 1.0)
    return (torch.arccos(dot) * mask.float()).sum()


def decoded_nhwc(m, sched: dict, unet_in: torch.Tensor, noisy, t: int, context, class_vec=None):
    v = m.unet(unet_in, t, context, class_vec)
    return m.vae.decode(x0_from_v(sched, noisy, v, t) / LATENT_SCALE).float().permute(0, 2, 3, 1)


def marigold_loss_sum(m, sched: dict, context: torch.Tensor, rgb, mask, target) -> torch.Tensor:
    """The SSI numerator of a block of rows (the loss is it over the batch's valid count)."""
    with torch.no_grad():
        lat = m.vae.encode_mean(rgb.permute(0, 3, 1, 2)) * LATENT_SCALE
    noisy = torch.zeros_like(lat)
    t = sched["num_train_timesteps"] - 1
    dec = decoded_nhwc(m, sched, torch.cat([lat, noisy], 1), noisy, t, context.expand(rgb.shape[0], -1, -1))
    return ssi_abs_sum(dec.mean(-1).clamp(-1.0, 1.0), target, mask)


def geowizard_loss_sums(m, sched: dict, rgb, mask, depth_t, normal_t, domain: str):
    """(SSI numerator, angular numerator) of a block of rows."""
    b = rgb.shape[0]
    with torch.no_grad():
        lat = m.vae.encode_mean(rgb.permute(0, 3, 1, 2)) * LATENT_SCALE
        embed = m.image_encoder(clip_pixels(rgb, m.clip_size))[:, None, :]
    lat2, context = torch.cat([lat, lat]), torch.cat([embed, embed])
    noisy = torch.zeros_like(lat2)
    t = sched["num_train_timesteps"] - 1
    dec = decoded_nhwc(m, sched, torch.cat([lat2, noisy], 1), noisy, t, context, switcher(domain, b, rgb.device))
    depth = dec[:b].mean(-1).clamp(-1.0, 1.0)
    normal = unit(dec[b:]).clamp(-1.0, 1.0)
    return ssi_abs_sum(depth, depth_t, mask), angular_sum(normal, -normal_t, mask)


def adamw_first_update(acc: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], hp: dict,
                       groups: Sequence[Sequence[str]]) -> Dict[str, torch.Tensor]:
    """The parameters' change of the first optimizer step on the accumulated
    gradient `acc`: per group (each with its learning-rate multiplier) clip to
    the global norm `max_grad_norm`, then AdamW at count 0 (bias-corrected
    moments from zero), decoupled weight decay, the learning rate at step 0."""
    out = {}
    b1, b2, eps, wd = hp["adam_beta1"], hp["adam_beta2"], hp["adam_epsilon"], hp["adam_weight_decay"]
    for names, mult in groups:
        if not names:
            continue
        norm = torch.linalg.vector_norm(torch.stack([acc[n].float().norm() for n in names]))
        clip = 1.0 if float(norm) < hp["max_grad_norm"] else hp["max_grad_norm"] / float(norm)
        lr = hp["learning_rate"] * lr_alpha(hp, 0) * mult
        for n in names:
            g = acc[n].float() * clip
            mu, nu = (1.0 - b1) * g, (1.0 - b2) * g * g
            u = (mu / (1.0 - b1)) / ((nu / (1.0 - b2)).sqrt() + eps) + wd * params[n].float()
            out[n] = -lr * u
    return out


def lr_alpha(hp: dict, step: int) -> float:
    """Linear warmup, then exponential decay to `lr_final_ratio` (Marigold's IterExponential)."""
    total, warm = hp["lr_total_iter_length"], hp["lr_warmup_steps"]
    if step >= total:
        return hp["lr_final_ratio"]
    if step < warm:
        return step / max(warm, 1)
    return math.exp((step - warm) / max(total - warm, 1) * math.log(hp["lr_final_ratio"]))
