"""The SDXL-shaped UNet in the port (`UNetConfig.sdxl()`: per-level transformer
depth, the text-time added embedding) against the benchmark's plain float32
reference (`benchmark/reference/sdxl.py`) on seeded weights at a tiny size on
the CPU: one UNet call, a 4-step `MarigoldPipeline.infer` and a served
request with a `unet` and a `scheduler` span a step; the HF config reader at
SDXL's published shape; and SD2's keys and outputs
unchanged by the per-level depth."""

import copy
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNet2DCondition, UNetConfig
from diffusion_e2e_ft_tpu_torch.models.layers import LayerNormFP32
from diffusion_e2e_ft_tpu_torch.ops.scheduler import SchedulerConfig
from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline, loading
from diffusion_e2e_ft_tpu_torch.utils import trace

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from lib import weights as W  # noqa: E402
from reference import models as ref  # noqa: E402
from reference import sdxl  # noqa: E402

FULL = json.loads((BENCH / "configs" / "marigold_sdxl_depth.json").read_text())
POOLED, TIME_DIM = 16, 8
TINY_UNET = {"block_out_channels": [32, 64, 64], "attention_head_dim": [2, 2, 4], "cross_attention_dim": 32,
             "transformer_layers_per_block": [1, 2, 3], "norm_num_groups": 8, "addition_time_embed_dim": TIME_DIM,
             "projection_class_embeddings_input_dim": POOLED + 6 * TIME_DIM}
TINY_VAE = {"block_out_channels": [8, 16, 16, 16], "layers_per_block": 1, "norm_num_groups": 4}
SEED = 4294967311
# fp32 on the CPU, the same math in another order (the port's attention and
# GroupNorm routes): read 1.1e-6 for a UNet call and 1.3e-6 after four steps
# and the decode; 2e-5 leaves room for another CPU's summation order, while a
# wrong time id, depth or step count moves the answers by over 1e-2
RTOL = 2e-5


@pytest.fixture(scope="module")
def tiny():
    cfg = copy.deepcopy(FULL)
    cfg["unet"].update(TINY_UNET)
    cfg["vae"].update(TINY_VAE)
    cfg["text_context_shape"], cfg["pooled_text_shape"] = [1, 4, 32], [1, POOLED]
    cfg["serve"].update(processing_res=32, dtype="float32")
    states = {}
    with torch.device("meta"):
        m = sdxl.Models(cfg)
    for kind in ("unet", "vae"):
        plan = ref.parameter_plan(getattr(m, kind))
        states[kind] = W.make_state(plan, SEED, W.MODULE_STREAMS[kind], "cpu", torch.float32)
        getattr(m, kind).load_state_dict(states[kind], strict=True, assign=True)
    m.requires_grad_(False)
    with torch.device("meta"):
        unet = UNet2DCondition(loading.unet_config_from_hf(cfg["unet"]))
        vae = AutoencoderKL(loading.vae_config_from_hf(cfg["vae"]))
    unet.load_state_dict(states["unet"], strict=True, assign=True)
    vae.load_state_dict(states["vae"], strict=True, assign=True)
    context = W.normal(tuple(cfg["text_context_shape"]), SEED, W.MODULE_STREAMS["text_context"], "cpu", torch.float32)
    pooled = W.normal(tuple(cfg["pooled_text_shape"]), SEED, W.MODULE_STREAMS["inputs"], "cpu", torch.float32)
    s = cfg["scheduler"]
    sched = SchedulerConfig(num_train_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
                            beta_end=s["beta_end"], beta_schedule=s["beta_schedule"],
                            prediction_type=s["prediction_type"], timestep_spacing=s["timestep_spacing"])
    pipe = MarigoldPipeline(unet, vae, sched, context, pooled_text_embed=pooled, device="cpu")
    return {"cfg": cfg, "ref": m, "pipe": pipe, "context": context, "pooled": pooled}


def close(got, want, rtol=RTOL):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    gap = (got - want).abs().max() / want.abs().max()
    assert gap <= rtol, f"max|d| / max|ref| = {gap:.3g}"


def test_one_unet_call_matches_the_reference(tiny):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 16, 12, generator=g)
    ids = sdxl.time_ids((128, 96), "cpu")
    with torch.no_grad():
        want = tiny["ref"].unet(x, 749, tiny["context"], tiny["pooled"], ids)
        got = tiny["pipe"].unet(x, 749, tiny["context"], text_embeds=tiny["pooled"], time_ids=ids)
        # the added embedding moves the answer: without it the port's UNet is another function
        other = tiny["ref"].unet(x, 749, tiny["context"], tiny["pooled"], sdxl.time_ids((96, 128), "cpu"))
    close(got, want)
    assert (other - want).abs().max() / want.abs().max() > 100 * RTOL


def test_four_step_infer_matches_the_reference(tiny):
    rgb = torch.rand(1, 24, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    want = sdxl.depth(tiny["ref"], tiny["cfg"], tiny["context"], tiny["pooled"], rgb)
    got = tiny["pipe"].infer(rgb, num_steps=4)[0]
    close(got, want)
    one = tiny["pipe"].infer(rgb, num_steps=1)[0]  # the steps change the answer
    assert (one - want).abs().max() > 100 * RTOL


def test_a_served_request_matches_the_reference_with_its_step_spans(tiny):
    image = np.random.default_rng(2).integers(0, 256, (24, 20, 3), dtype=np.uint8)
    service = PipelineService(tiny["pipe"], 32, 4)
    want = sdxl.request(tiny["ref"], tiny["cfg"], tiny["context"], tiny["pooled"], image)["depth"]
    trace.clear()
    with torch.autograd.profiler.profile(use_cpu=True):
        got = service.predict(image, normals=False)
    spans = trace.spans()
    trace.clear()
    assert got.shape == want.shape == image.shape[:2]
    assert np.abs(got - want).max() <= 10 * RTOL  # min-max normalised: the gap over a range of 1, widened by it
    assert all(s.attrs is None for s in spans)  # the counters run on a card only
    names = [s.name for s in spans]
    assert names.count("unet") == names.count("scheduler") == 4


def test_the_hf_reader_builds_sdxl_at_its_published_shape():
    cfg = loading.unet_config_from_hf(FULL["unet"])
    assert cfg == UNetConfig.sdxl()
    assert cfg.transformer_depths == (1, 2, 10) and cfg.addition_embed_type == "text_time"
    assert cfg.addition_embed_input_dim == 2816 and cfg.addition_time_embed_dim == 256
    assert loading.unet_config_from_hf(loading.unet_config_to_hf(cfg)) == cfg
    with torch.device("meta"):
        port, want = UNet2DCondition(cfg), sdxl.UNet(FULL["unet"])
    keys = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert keys == {k: tuple(v.shape) for k, v in want.state_dict().items()}
    assert sum(1 for k in keys if k.endswith("attn1.to_q.weight")) == 70
    assert keys["add_embedding.linear_1.weight"] == (1280, 2816)
    port.load_state_dict(want.state_dict(), strict=True, assign=True)


@pytest.mark.parametrize("preset", ["sd2", "geowizard"])
def test_an_sd_unet_is_unchanged_by_the_per_level_depth(preset):
    base = UNetConfig.tiny() if preset == "sd2" else UNetConfig.tiny(class_embed_proj_dim=10, joint_attention=True)
    torch.manual_seed(0)
    a = UNet2DCondition(base).eval()
    b = UNet2DCondition(dataclasses.replace(base, transformer_depth=(1, 1, 1, 1))).eval()
    assert a.add_embedding is None and list(a.state_dict()) == list(b.state_dict())
    b.load_state_dict(a.state_dict())
    hf = {"block_out_channels": [32, 64, 64, 64], "attention_head_dim": 2, "cross_attention_dim": 32,
          "in_channels": 8, "out_channels": 4, "layers_per_block": 2, "norm_num_groups": 32, "norm_eps": 1e-5,
          "use_linear_projection": True, "flip_sin_to_cos": True, "freq_shift": 0,
          "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"]}
    if preset == "sd2":  # the reference's SD2 UNet holds the same keys
        with torch.device("meta"):
            assert sorted(ref.UNet(hf).state_dict()) == sorted(a.state_dict())
    g = torch.Generator().manual_seed(3)
    x, ctx = torch.randn(2, 8, 16, 16, generator=g), torch.randn(2, 3, 32, generator=g)
    cls = torch.randn(2, 10, generator=g) if preset == "geowizard" else None
    with torch.no_grad():
        assert torch.equal(a(x, 999, ctx, cls), b(x, 999, ctx, cls))


@pytest.mark.card
def test_on_the_card_a_bf16_layer_norm_is_one_launch_within_an_ulp_of_the_fp32_path():
    """The transformer blocks' norms: a bf16 input takes PyTorch's one CUDA
    launch in place of the casts around an fp32 call, and rounds once, as the
    fp32 call's cast does (up to the last bit of the statistics' sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    x = (torch.randn(2, 4096, 640, device=dev, generator=g) * 3 + 1).bfloat16()
    norm = LayerNormFP32(640).to(dev, torch.bfloat16)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1, generator=g)
        norm.bias.normal_(0.0, 0.1, generator=g)
        want = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = norm(x)
            torch.cuda.synchronize()
    launches = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(launches) == 1, [e.name for e in launches]
    assert got.dtype == torch.bfloat16
    assert ((got.float() - want).abs() <= want.abs() * 2.0 ** -7 + 1e-6).all()  # a bf16 ulp
