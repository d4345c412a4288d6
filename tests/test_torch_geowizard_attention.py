"""GeoWizard's joint attention in the torch port: the plain version against the
JAX package's `joint_attention` (XLA) at the SD1.5 head dims, and against the
JAX Pallas path in interpreter mode with heads per program (`E2EFT_FA_HP`,
the TPU kernel `_flash_kernel_mh`); the heads-per-block selection rule; and
the CUDA routes, decided from shapes alone (there is no card here).

The kernels themselves run only on the card; `chip_smoke.py` holds them to
the plain version there.

Tolerance 1e-5: fp32 on both sides, the softmax summed in another order
(online over KV blocks on the Pallas side)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu.kernels import flash_attention as jfa
from diffusion_e2e_ft_tpu_torch import kernels
from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as tfa

# the modules (each package's `kernels.attention` attribute is the function)
jattn = importlib.import_module("diffusion_e2e_ft_tpu.kernels.attention")
tattn = importlib.import_module("diffusion_e2e_ft_tpu_torch.kernels.attention")

ATOL = 1e-5


def _qkv(two_b, length, n, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((two_b, length, n, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("two_b", [2, 4])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_joint_attention_matches_jax(two_b, d):
    q, k, v = _qkv(two_b, 48, 2, d, seed=d + two_b)
    want = np.asarray(jattn.joint_attention(*(jnp.asarray(x) for x in (q, k, v))))
    got = kernels.joint_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    assert got.shape == (two_b, 48, 2, d)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_joint_attention_couples_the_halves():
    """Changing the normal half's keys moves the depth half's output."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 16, 2, 40, seed=7))
    k2 = k.clone()
    k2[1] += 1.0
    a, b = kernels.joint_attention(q, k, v), kernels.joint_attention(q, k2, v)
    assert not torch.allclose(a[0], b[0])


@pytest.fixture
def pallas_heads_per_program(monkeypatch):
    """The JAX Pallas path in interpreter mode, with a spy that shows the
    heads-per-program kernel body ran."""
    calls = []
    kernel = jfa._flash_kernel_mh

    def spy(*args, **kw):
        calls.append(kw["hp"])
        return kernel(*args, **kw)

    monkeypatch.setattr(jfa, "_flash_kernel_mh", spy)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    jattn.set_backend("pallas")
    yield calls
    jattn.set_backend(None)


@pytest.mark.parametrize("hp", [2, 4])
def test_joint_attention_matches_pallas_heads_per_program(pallas_heads_per_program, monkeypatch, hp):
    monkeypatch.setenv("E2EFT_FA_HP", str(hp))
    q, k, v = _qkv(2, 256, 4, 40, seed=hp)  # joint: [1, 512, 4, 40], 4 heads -> 4 / hp programs
    want = np.asarray(jattn.joint_attention(*(jnp.asarray(x) for x in (q, k, v))))
    assert pallas_heads_per_program and set(pallas_heads_per_program) == {hp}
    got = kernels.joint_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_heads_per_cta_rule(monkeypatch):
    geowizard = (8, 18432, 18432, 40)  # level 0 of the joint UNet at 768x768
    assert tfa.heads_per_cta(*geowizard) == 1  # default off
    for hp in (2, 4, 8):
        monkeypatch.setenv("E2EFT_FA_HP", str(hp))
        assert tfa.heads_per_cta(*geowizard) == hp
    monkeypatch.setenv("E2EFT_FA_HP", "2")
    assert tfa.heads_per_cta(8, 9216, 9216, 64) == 1  # wide heads: never
    assert tfa.heads_per_cta(8, 4608, 4608, 80) == 1
    assert tfa.heads_per_cta(5, 18432, 18432, 40) == 1  # B*N not divisible
    assert tfa.MH_TILE == (128, 64)  # the d=40 kernel's Q and KV tiles
    assert tfa.heads_per_cta(8, 32, 18432, 40) == 1  # Lq under one tile
    assert tfa.heads_per_cta(8, 100, 18432, 40) == 1  # Lq under one 128-row Q tile
    assert tfa.heads_per_cta(8, 128, 64, 40) == 2  # one Q tile and one KV tile
    assert tfa.heads_per_cta(8, 18432, 32, 40) == 1  # Lk under one tile
    for unbuilt in ("3", "16", "0"):  # values the JAX rule could take but the kernel is not built for
        monkeypatch.setenv("E2EFT_FA_HP", unbuilt)
        assert tfa.heads_per_cta(48, 18432, 18432, 40) == 1


@pytest.mark.parametrize(
    "lq,lk,d,needs_grad,route",
    [
        (18432, 18432, 40, False, "forward"),  # GeoWizard level 0 (joint)
        (4608, 4608, 80, False, "forward"),
        (288, 288, 160, False, "forward"),  # the 768x768 mid block: inside the port's envelope
        (216, 216, 160, False, "plain"),  # the 576x768 mid block: under 256 tokens
        (18432, 1, 40, False, "plain"),  # cross-attention over the image embedding
        (18432, 1, 40, True, "plain"),
        (9216, 9216, 64, True, "autograd"),  # the SD2 trainer's sites
        (4800, 4800, 512, True, "autograd"),
    ],
)
def test_cuda_routes(lq, lk, d, needs_grad, route):
    assert tattn.cuda_route(lq, lk, d, needs_grad) == route


@pytest.mark.parametrize("d", [40, 80, 160])
def test_cuda_route_under_grad_raises_at_geowizard_head_dims(d):
    """Under grad, GeoWizard's head dims take the differentiable route (the
    backward kernels) as the SD2 ones do; nothing raises."""
    assert kernels.in_kernel_envelope(9216, 9216, d)
    assert d in tfa.GRAD_HEAD_DIMS and tfa.GRAD_HEAD_DIMS == tfa.HEAD_DIMS
    assert tattn.cuda_route(9216, 9216, d, needs_grad=True) == "autograd"
    assert tattn.cuda_route(9216, 9216, d, needs_grad=False) == "forward"


def test_cpu_joint_attention_is_differentiable_and_launches_nothing():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(2, 300, 2, 40, seed=3))
    before = dict(tfa.launches)
    out = kernels.joint_attention(q, k, v)
    out.square().sum().backward()
    assert all(float(t.grad.abs().max()) > 0 for t in (q, k, v))
    assert tfa.launches == before


def test_mh_wrapper_refusals():
    q = torch.zeros(1, 256, 8, 40)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_mh(q, q, q, None, 2)
    w = torch.zeros(1, 256, 8, 64)
    with pytest.raises(ValueError, match="head dim 64"):
        tfa.flash_attention_mh(w, w, w, None, 2)
