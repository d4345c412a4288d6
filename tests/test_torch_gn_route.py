"""The port's kernel-backed GroupNorm route (`kernels/groupnorm.py`) against the
JAX package's (`diffusion_e2e_ft_tpu/kernels/groupnorm.py`), on the CPU.

The JAX side runs its Pallas statistics kernel in interpret mode
(`GN.INTERPRET`, as `tests/test_groupnorm_kernel.py` does), called eagerly
each time (no jit cache carries a trace between tests). The port's side is
the kernels' plain versions: `group_norm_apply_reference` on
`channel_stats_reference`'s sums, and `GroupNormFunction` with its forward
taken by `PLAIN`. The CUDA kernels themselves run only on the card, where
`chip_smoke.py` phase 4c holds them to these plain versions.

Layouts: JAX [B, N, C], the port [B, C, H, W] with N = H * W. Inputs come
from a seeded numpy rng. Tolerances, as max |d| / max |JAX|: 1e-5 in fp32
(summation order: XLA's and ATen's sums of 64-320 channels' moments), 1e-4
at a mean of 10 (E[x^2] - E[x]^2 cancels ~2 of fp32's 7 digits, as the
GroupNorm large-mean case of `test_torch_models.py`); bf16 IO within one
bf16 ulp of each JAX value plus the fp32 bound (both round the same fp32
math to bf16, but near zero x * a + b and (x - mean) * inv * w + b differ in
fp32 by more than a bf16 ulp of the tiny result).
"""

import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, nchw, nhwc, random_flax_params
from diffusion_e2e_ft_tpu.kernels import groupnorm as GN
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu_torch.kernels import gn_conv as tgc
from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as tgn
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, UNetConfig, VAEConfig

GROUPS, EPS = 32, 1e-6
# (B, N, C) <-> (B, C, H, W)
SHAPES = {(2, 300, 64): (15, 20), (1, 1000, 128): (25, 40), (2, 2100, 320): (42, 50)}
# a tiny VAE whose GroupNorms are 128 wide: the JAX dispatcher's lane rule (C % 128) sends every one to `_fused`
TINY_128_VAE = dict(block_out_channels=(128,), layers_per_block=1, norm_num_groups=GROUPS)


@pytest.fixture(autouse=True)
def interpret_mode():
    GN.INTERPRET = True
    yield
    GN.INTERPRET = False


def inputs(shape, seed, loc=0.0):
    rng = np.random.default_rng(seed)
    x = (loc + rng.standard_normal(shape)).astype(np.float32)
    c = shape[-1]
    return x, (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.5 * rng.standard_normal(c)).astype(np.float32)


def to_port(x_bnc: np.ndarray, hw) -> torch.Tensor:
    b, _, c = x_bnc.shape
    return torch.from_numpy(np.ascontiguousarray(x_bnc.transpose(0, 2, 1))).reshape(b, c, *hw)


def to_bnc(t: torch.Tensor) -> np.ndarray:
    return t.float().reshape(t.shape[0], t.shape[1], -1).permute(0, 2, 1).numpy()


def port_route(x: torch.Tensor, w, b, silu: bool) -> torch.Tensor:
    """The kernels' plain versions, as the route chains them: statistics, then apply."""
    return tgn.group_norm_apply_reference(x, tgn.channel_stats_reference(x), torch.from_numpy(w),
                                          torch.from_numpy(b), GROUPS, EPS, silu)


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: "x".join(map(str, s)))
def test_apply_reference_matches_pallas_group_norm(shape, silu):
    x, w, b = inputs(shape, 0)
    want = np.asarray(GN._pallas_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), GROUPS, EPS, silu))
    got = to_bnc(port_route(to_port(x, SHAPES[shape]), w, b, silu))
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 300, 64), (2, 2100, 320)], ids=lambda s: "x".join(map(str, s)))
def test_apply_reference_large_mean(shape):
    x, w, b = inputs(shape, 1, loc=10.0)
    want = np.asarray(GN._pallas_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), GROUPS, EPS, True))
    got = to_bnc(port_route(to_port(x, SHAPES[shape]), w, b, True))
    assert rel(got, want) <= 1e-4


def test_apply_reference_bf16_io():
    shape = (1, 1000, 128)
    x, w, b = inputs(shape, 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(GN._pallas_group_norm(xb, jnp.asarray(w), jnp.asarray(b), GROUPS, EPS, True)).astype(np.float32)
    xt = to_port(np.asarray(xb.astype(jnp.float32)), SHAPES[shape]).to(torch.bfloat16)
    out = port_route(xt, w, b, True)
    assert out.dtype == torch.bfloat16
    got = to_bnc(out)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)  # bf16: 8 significant bits
    excess = (np.abs(got - want) - ulp).max() / np.abs(want).max()
    assert excess <= 1e-5, excess


def test_function_gradient_matches_fused_vjp():
    shape = (2, 300, 64)
    x, w, b = inputs(shape, 3)
    g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda x, s, b: GN._fused(x, s, b, GROUPS, EPS, True), *map(jnp.asarray, (x, w, b)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    leaves = [to_port(x, SHAPES[shape]), torch.from_numpy(w), torch.from_numpy(b)]
    leaves = [t.requires_grad_(True) for t in leaves]
    got_out = tgn.GroupNormFunction.apply(*leaves, GROUPS, EPS, True, tgn.PLAIN)
    got = torch.autograd.grad(got_out, leaves, to_port(g, SHAPES[shape]))
    assert rel(to_bnc(got_out.detach()), np.asarray(out)) <= 1e-5
    assert rel(to_bnc(got[0]), want[0]) <= 1e-5
    for port, jax_grad in zip(got[1:], want[1:]):
        assert rel(port.numpy(), jax_grad) <= 1e-5


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
def test_dispatcher_on_cpu_is_the_reference(silu):
    x, w, b = inputs((2, 300, 64), 5)
    xt, wt, bt = to_port(x, SHAPES[(2, 300, 64)]), torch.from_numpy(w), torch.from_numpy(b)
    before = dict(tgn.launches)
    assert torch.equal(tgn.group_norm_silu(xt, wt, bt, GROUPS, EPS, silu),
                       tgn.group_norm_reference(xt, wt, bt, GROUPS, EPS, silu))
    assert tgn.launches == before  # no kernel counted on the CPU


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches the library."""
    x = torch.randn(1, 64, 4, 4)
    w, b = torch.ones(64), torch.zeros(64)
    before = dict(tgn.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_apply(x, tgn.channel_stats_reference(x), w, b, GROUPS, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        tgn.group_norm_kernel(x, w, b, GROUPS, EPS)
    assert tgn.launches == before


def test_gn_conv_plain_composite_keeps_plain_group_norm():
    """`gn_conv_reference` (the yardstick of kernels 7 and 8, and their
    backward's recompute) normalizes with `group_norm_reference` itself, not
    the dispatcher, and `fold_stats` is one function in both modules."""
    assert tgc.fold_stats is tgn.fold_stats
    assert "group_norm_silu" not in vars(tgc)  # the module never reaches the dispatcher
    x, w, b = inputs((1, 60, 128), 8)
    x = to_port(x, (6, 10))
    weight = torch.from_numpy(np.random.default_rng(9).standard_normal((64, 128, 3, 3)).astype(np.float32) * 0.03)
    got = tgc.gn_conv_reference(x, torch.from_numpy(w), torch.from_numpy(b), GROUPS, EPS, weight, None)
    y = tgn.group_norm_reference(x, torch.from_numpy(w), torch.from_numpy(b), GROUPS, EPS, True)
    assert torch.equal(got, torch.nn.functional.conv2d(y, weight, padding=1))


def test_tiny_decode_matches_jax_fused_route(monkeypatch):
    """A VAE decode whose every GroupNorm takes the JAX package's kernel route
    (`_fused` -> `_pallas_group_norm`, interpreted), against the port on the
    CPU. Same bound as `test_torch_models.py::test_vae_decode`."""
    jm = JVAE(JVAEConfig(**TINY_128_VAE))
    p = random_flax_params(jm, 6, jnp.ones((1, 8, 8, 3)))
    tm = load_into(AutoencoderKL(VAEConfig(**TINY_128_VAE)), p)
    calls = []
    route = GN._pallas_group_norm
    monkeypatch.setattr(GN, "_pallas_group_norm", lambda *a: calls.append(a[0].shape) or route(*a))
    z = np.random.default_rng(7).standard_normal((1, 4, 6, 4)).astype(np.float32)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(z), method=jm.decode))
    # the decoder's 10 GroupNorms: mid block 2 resnets + attention, one level of 2 resnets, conv_norm_out
    assert len(calls) == 10
    with torch.inference_mode():
        got = nhwc(tm.decode(nchw(z)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def load_chip_smoke(monkeypatch):
    """`chip_smoke.py` as a module; the CUDA_VISIBLE_DEVICES it sets at import is undone after the test."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", os.environ.get("CUDA_VISIBLE_DEVICES", ""))
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_counts_the_route_from_the_module_tree(monkeypatch):
    """`chip_smoke.py`'s launch expectations come from the GroupNormAct
    modules a forward visits (on the meta device): 61 in the SD2 UNet, 22 in
    the VAE encoder and 30 in the decoder; 2 and 2 outside the fused VAE's
    GN -> conv pairs; each GroupNorm of a step one launch of the one-launch
    kernel or one of the statistics and one of the apply."""
    cs = load_chip_smoke(monkeypatch)
    counts = {part: cs.norm_count(part) for part in ("unet", "encoder", "decoder")}
    assert counts == {"unet": 61, "encoder": 22, "decoder": 30}
    assert (cs.norm_count("encoder", fused=True), cs.norm_count("decoder", fused=True)) == (2, 2)
    assert cs.norm_count("unet", config=UNetConfig.geowizard()) == 61  # its steps share step_launches' SD2 count
    assert cs.request_norms(1, 1) == 113
    step = cs.step_launches(15)
    assert step["gn_group"] + step["gn_apply"] == 2 * 61 + 2 + 2 and step["gn_channel_stats"] == step["gn_apply"] + 48
    assert set(cs.norm_visits("decoder", 1, (768, 768))) >= {(1, 128, 768, 768), (1, 512, 96, 96)}


def test_chip_smoke_route_shapes_cover_every_batched_path(monkeypatch):
    """Phase 4c's shapes include the batched paths' GroupNorms: GeoWizard's
    joint UNet and decode at 2B (serving and the 5-member ensemble), the
    baseline's and the LCM request's `find_batch_size` batches, the
    diffusion-loss step's encode of the GT at 2B, the parity runs and the
    train step's unfused arm."""
    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    cs = load_chip_smoke(monkeypatch)
    shapes = cs.route_shapes()
    base = MarigoldPipeline.find_batch_size(cs.BASELINE["ensemble_size"], max(cs.BASELINE_HW))
    lcm = MarigoldPipeline.find_batch_size(cs.LCM_REQUEST["ensemble_size"], max(cs.LCM_HW))
    want = {
        (2, 256, 768, 768), (2, 320, 96, 96), (2, 256, 576, 768),  # GeoWizard serving: decode and UNet at 2B
        (10, 256, 576, 768), (10, 1280, 9, 12),  # the GeoWizard ensemble, 5 members a call
        (base, 256, 480, 640), (base, 320, 60, 80),  # the baseline
        (lcm, 256, 768, 768), (lcm, 640, 48, 48),  # the LCM request
        (4, 512, 60, 80),  # GeoWizard's diffusion-loss step: the fused encoder's standalone GroupNorms at 2B
        (3, 128, 256, 256),  # phase 14's 3-member decode
        (2, 256, 512, 512), (2, 2560, 16, 16),  # GeoWizard's 512x512 parity image
        (2, 128, 240, 320), (2, 256, 120, 160),  # the unfused VAE's encoder in the train step's A/B
    }
    assert want <= shapes, sorted(want - shapes)
    assert all(cs.route_visits(path) and sum(cs.route_visits(path).values()) >= 65 for path in cs.route_paths())
