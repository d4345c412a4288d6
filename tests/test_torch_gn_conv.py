"""The fused GroupNorm(+SiLU) -> conv3x3 in the torch port against the JAX
package on the CPU: the plain statistics against the Pallas statistics kernel
and the plain composite against `_xla_gn_conv` and the Pallas v1 / v2 kernels
(interpreter mode), `fold_stats`, the autograd Function's wiring (with the
plain forward), the fused ResnetBlock and VAE, the envelope at the SD2 VAE's
shapes, and the compute-dtype rule under autocast.

The kernels run only on the card; `chip_smoke.py` holds them to their plain
versions there. Every case has a non-zero GroupNorm bias: the conv pads the
activation with zeros, and silu(0 * a + b) is not 0, so a kernel that padded
x instead would differ at every border pixel.

Tolerances: fp32 on both sides, differing only in summation order (XLA vs
ATen convolutions, blocked vs one-pass sums): 1e-5 relative to max(1, |ref|)
for one pair; 1e-4 for a whole VAE tower, as `tests/test_torch_models.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import load_into, nchw, nhwc, random_flax_params
from diffusion_e2e_ft_tpu.kernels import gn_conv as jgc
from diffusion_e2e_ft_tpu.kernels import groupnorm as jgn
from diffusion_e2e_ft_tpu.models import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from diffusion_e2e_ft_tpu.models import layers as jl
from diffusion_e2e_ft_tpu_torch.kernels import gn_conv as tgc
from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as tgn
from diffusion_e2e_ft_tpu_torch.models import AutoencoderKL, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import layers as tl

GROUPS, EPS = 32, 1e-6
# (B, H, W, C, Cout): C != Cout, ragged H * W, H != W
SHAPES = [(1, 12, 16, 128, 128), (2, 8, 10, 256, 128), (1, 5, 7, 128, 256)]
SHAPE_IDS = ["c128", "c256-to-128", "ragged-128-to-256"]


@pytest.fixture
def interpret_mode():
    jgc.INTERPRET = jgn.INTERPRET = True
    yield
    jgc.INTERPRET = jgn.INTERPRET = False


def _inputs(b, h, w, c, co, seed, residual=False):
    """NHWC / HWIO numpy arrays: x, GN scale and (non-zero) bias, conv kernel
    and bias, and optionally a residual."""
    rng = np.random.default_rng(seed)
    arrays = {
        "x": (0.5 + rng.standard_normal((b, h, w, c))).astype(np.float32),
        "scale": (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32),
        "bias": (0.5 * rng.standard_normal(c)).astype(np.float32),
        "kernel": (rng.standard_normal((3, 3, c, co)) / np.sqrt(9 * c)).astype(np.float32),
        "conv_bias": (0.1 * rng.standard_normal(co)).astype(np.float32),
    }
    if residual:
        arrays["residual"] = rng.standard_normal((b, h, w, co)).astype(np.float32)
    return arrays


def _port_args(a):
    """The same values in the port's layouts: NCHW activations, OIHW weights."""
    return dict(x=nchw(a["x"]), gn_weight=torch.from_numpy(a["scale"]), gn_bias=torch.from_numpy(a["bias"]),
                weight=torch.from_numpy(np.ascontiguousarray(np.transpose(a["kernel"], (3, 2, 0, 1)))),
                conv_bias=torch.from_numpy(a["conv_bias"]))


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("b,h,w,c,co", SHAPES, ids=SHAPE_IDS)
def test_channel_stats_reference_matches_pallas(interpret_mode, b, h, w, c, co):
    x = _inputs(b, h, w, c, co, seed=1)["x"]
    want = np.asarray(jgn._channel_stats(jnp.asarray(x.reshape(b, h * w, c))))
    got = tgn.channel_stats_reference(nchw(x))
    assert got.shape == (b, 2, c) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize(
    "silu,residual", [(True, False), (False, False), (True, True)], ids=["silu", "no-silu", "silu-residual"]
)
@pytest.mark.parametrize("b,h,w,c,co", SHAPES[:2], ids=SHAPE_IDS[:2])
def test_reference_matches_xla_composite(b, h, w, c, co, silu, residual):
    a = _inputs(b, h, w, c, co, seed=2, residual=residual)
    want = np.asarray(jgc._xla_gn_conv(
        jnp.asarray(a["x"]), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]), GROUPS, EPS, silu,
        jnp.asarray(a["kernel"]), jnp.asarray(a["conv_bias"]), jnp.asarray(a["residual"]) if residual else None,
    ))
    got = tgc.gn_conv_reference(**_port_args(a), groups=GROUPS, eps=EPS, silu=silu,
                                residual=nchw(a["residual"]) if residual else None)
    _close(nhwc(got), want)


def _ab_composite(x, gn_weight, gn_bias, weight, conv_bias, silu):
    """The kernels' math in plain torch: `fold_stats` a, b, then
    conv3x3(act(x * a + b)) + bias, zero-padded after the activation."""
    ab = tgc.fold_stats(tgn.channel_stats_reference(x), gn_weight, gn_bias, GROUPS, EPS, x.shape[2] * x.shape[3])
    y = x * ab[:, 0, :, None, None] + ab[:, 1, :, None, None]
    if silu:
        y = torch.nn.functional.silu(y)
    return torch.nn.functional.conv2d(y, weight, conv_bias, padding=1)


@pytest.mark.parametrize("impl", ["v1", "v2"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "no-silu"])
@pytest.mark.parametrize("b,h,w,c,co", SHAPES, ids=SHAPE_IDS)
def test_reference_and_fold_match_pallas(interpret_mode, b, h, w, c, co, silu, impl):
    """Both of the port's plain routes (the GroupNorm composite, and fold_stats'
    a, b applied as the kernels apply them) against the TPU kernel's output."""
    a = _inputs(b, h, w, c, co, seed=3)
    fn = jgc._pallas_gn_conv if impl == "v1" else jgc._pallas_gn_conv_v2
    want = np.asarray(fn(jnp.asarray(a["x"]), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]), GROUPS, EPS, silu,
                         jnp.asarray(a["kernel"]), jnp.asarray(a["conv_bias"])))
    args = _port_args(a)
    _close(nhwc(tgc.gn_conv_reference(**args, groups=GROUPS, eps=EPS, silu=silu)), want)
    _close(nhwc(_ab_composite(**args, silu=silu)), want)


@pytest.mark.parametrize("loc", [0.0, 30.0], ids=["centred", "large-mean"])
def test_fold_stats_is_group_norm(loc):
    """x * a + b with fold_stats' a, b is the GroupNorm (no SiLU); at a large
    mean the one-pass variance cancels and is clamped at 0 (a constant group)."""
    a = _inputs(2, 6, 5, 128, 128, seed=4)
    x = nchw(a["x"]) + loc
    x[0, :4] = 0.3  # group 0 of image 0 is constant: its one-pass variance rounds to about 0
    gw, gb = torch.from_numpy(a["scale"]), torch.from_numpy(a["bias"])
    ab = tgc.fold_stats(tgn.channel_stats_reference(x), gw, gb, GROUPS, EPS, 30)
    assert ab.shape == (2, 2, 128) and ab.dtype == torch.float32
    got = x * ab[:, 0, :, None, None] + ab[:, 1, :, None, None]
    want = tgn.group_norm_silu(x, gw, gb, GROUPS, EPS, silu=False)
    assert torch.isfinite(got).all()
    # at mean 30 the fp32 one-pass moments keep ~3 fewer digits
    _close(got.numpy(), want.numpy(), rel=1e-5 if loc == 0 else 1e-3)


def _grads(fn, args, grad_out, wanted):
    leaves = {k: v.clone().requires_grad_(k in wanted) for k, v in args.items()}
    out = fn(leaves)
    return out.detach(), torch.autograd.grad(out, [leaves[k] for k in wanted], grad_out)


@pytest.mark.parametrize("wanted", [("x", "gn_weight", "gn_bias", "weight", "conv_bias"), ("x",)],
                         ids=["all-inputs", "x-only"])
def test_function_plain_wiring_matches_autograd(wanted):
    """GNConvFunction with the plain forward: the same output, and the
    recomputed composite's gradients, for the inputs that ask for one (the
    frozen VAE asks for dx only)."""
    a = _inputs(2, 6, 7, 128, 256, seed=5)
    args = _port_args(a)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 256, 6, 7)).astype(np.float32))

    def function(t):
        return tgc.GNConvFunction.apply(t["x"], t["gn_weight"], t["gn_bias"], t["weight"], t["conv_bias"],
                                        GROUPS, EPS, True, tgc.PLAIN)

    def composite(t):
        return tgc.gn_conv_reference(t["x"], t["gn_weight"], t["gn_bias"], GROUPS, EPS, t["weight"], t["conv_bias"])

    got, want = _grads(function, args, g, wanted), _grads(composite, args, g, wanted)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for name, x, y in zip(wanted, got[1], want[1]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5, msg=name)


def test_resnet_block_fused_matches_standard_and_jax():
    """The fused ResnetBlock (time embedding and 1x1 shortcut included) on the
    standard block's weights, and against the JAX package's fused block."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 5, 128)).astype(np.float32)
    temb = rng.standard_normal((2, 24)).astype(np.float32)
    jm = jl.ResnetBlock(256, groups=GROUPS, eps=EPS, fused=True)
    p = random_flax_params(jm, 8, x, temb)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(temb)))
    out = {}
    for fused in (False, True):
        tm = load_into(tl.ResnetBlock(128, 256, groups=GROUPS, eps=EPS, temb_channels=24, fused=fused), p)
        out[fused] = tm(nchw(x), torch.from_numpy(temb))
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-5)
    _close(nhwc(out[True]), want)


VAE_CFG = dict(block_out_channels=(128, 128), layers_per_block=1, norm_num_groups=GROUPS)


@pytest.fixture(scope="module")
def fused_vae_pair():
    jm = JVAE(JVAEConfig(**VAE_CFG, fused_gn_conv=True))
    p = random_flax_params(jm, 9, jnp.ones((1, 16, 16, 3)))
    return jm, p, load_into(AutoencoderKL(VAEConfig(**VAE_CFG, fused_gn_conv=True)), p)


def test_fused_vae_decode_matches_jax(fused_vae_pair):
    """Channels the card's envelope takes (128, 32 groups): on the CPU both
    packages run their plain composites."""
    jm, p, tm = fused_vae_pair
    assert all(r.fused for r in tm.modules() if isinstance(r, tl.ResnetBlock))
    z = np.random.default_rng(10).standard_normal((1, 8, 6, 4)).astype(np.float32)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(z), method=jm.decode))
    with torch.inference_mode():
        got = tm.decode(nchw(z))
    assert got.shape == (1, 3, 16, 12)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4, rtol=0)


def test_fused_vae_encode_matches_jax(fused_vae_pair):
    jm, p, tm = fused_vae_pair
    x = np.tanh(np.random.default_rng(11).standard_normal((1, 16, 12, 3))).astype(np.float32)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), method=jm.encode_mean))
    with torch.inference_mode():
        np.testing.assert_allclose(nhwc(tm.encode_mean(nchw(x))), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "c,groups,ksize,inside",
    [(128, 32, (3, 3), True), (512, 32, (3, 3), True), (96, 32, (3, 3), False), (128, 48, (3, 3), False),
     (256, 32, (1, 1), False)],
    ids=["c128", "c512", "c96", "groups48", "1x1"],
)
def test_envelope(c, groups, ksize, inside):
    assert tgc.in_envelope(c, groups, ksize) is inside


def test_sd2_vae_pairs_in_envelope(monkeypatch):
    """The 480x640 train step's frozen SD2 VAE (shapes traced on the meta
    device): 20 GN -> conv pairs in the encoder (10 ResnetBlocks) and 28 in the
    decoder (14), every one inside the kernels' envelope, at 128 / 256 / 512
    channels."""
    calls = []

    def record(x, gn_weight, gn_bias, groups, eps, weight, conv_bias, silu=True, residual=None):
        calls.append((x.shape[1], weight.shape[0], groups, tuple(weight.shape[2:]), x.shape[2:]))
        return torch.empty((x.shape[0], weight.shape[0], *x.shape[2:]), device=x.device)

    monkeypatch.setattr(tl, "gn_silu_conv3x3", record)
    with torch.device("meta"), torch.inference_mode():
        vae = AutoencoderKL(VAEConfig(fused_gn_conv=True))
        z = vae.encode_mean(torch.empty(2, 3, 480, 640))
        encoder_pairs = len(calls)
        vae.decode(z)
    assert (encoder_pairs, len(calls)) == (20, 48)
    assert all(tgc.in_envelope(c, g, k) for c, _, g, k, _ in calls)
    assert {c for c, *_ in calls} == {128, 256, 512}
    assert max(hw for *_, hw in calls) == (480, 640)


def test_compute_dtype_rule_under_cpu_autocast():
    """Under autocast the compute dtype is the autocast dtype: x and the weight
    are cast to it, the statistics stay fp32, the output is in it; outside
    autocast it is x's dtype."""
    args = _port_args(_inputs(1, 6, 7, 128, 128, seed=12))
    res = nchw(_inputs(1, 6, 7, 128, 128, seed=13)["x"])
    assert tgc.gn_silu_conv3x3(**args, groups=GROUPS, eps=EPS).dtype == torch.float32
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert tgc.compute_dtype(args["x"]) == torch.bfloat16
        got = tgc.gn_silu_conv3x3(**args, groups=GROUPS, eps=EPS, residual=res)
    want = tgc.gn_conv_reference(**{**args, "x": args["x"].bfloat16(), "weight": args["weight"].bfloat16()},
                                 groups=GROUPS, eps=EPS, residual=res)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_dispatch_takes_plain_path():
    args = _port_args(_inputs(1, 6, 7, 128, 128, seed=14))
    before = (dict(tgn.launches), dict(tgc.launches))
    got = tgc.gn_silu_conv3x3(**args, groups=GROUPS, eps=EPS)
    torch.testing.assert_close(got, tgc.gn_conv_reference(**args, groups=GROUPS, eps=EPS), rtol=0, atol=0)
    assert (tgn.launches, tgc.launches) == before


@pytest.mark.parametrize("fn", ["channel_stats", "gn_conv_kernel"])
def test_wrappers_refuse_cpu_tensors(fn):
    args = _port_args(_inputs(1, 4, 4, 128, 128, seed=15))
    with pytest.raises(ValueError, match="CUDA tensor"):
        if fn == "channel_stats":
            tgn.channel_stats(args["x"])
        else:
            tgc.gn_conv_kernel(**args, groups=GROUPS, eps=EPS)


def test_impl_read_at_call_time(monkeypatch):
    monkeypatch.delenv("E2EFT_GNCONV_IMPL", raising=False)
    assert tgc.impl() == "v1"
    monkeypatch.setenv("E2EFT_GNCONV_IMPL", "v2")
    assert tgc.impl() == "v2"
    monkeypatch.setenv("E2EFT_GNCONV_IMPL", "v3")
    with pytest.raises(ValueError, match="E2EFT_GNCONV_IMPL"):
        tgc.impl()
