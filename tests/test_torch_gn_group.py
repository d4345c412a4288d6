"""The port's one-launch GroupNorm (`csrc/groupnorm.cu::gn_group_kernel`
behind `kernels/groupnorm.py::group_norm_kernel`, one C call a GroupNorm) on
the CPU: its shape rule against the source and the full-width module trees,
its C signature against the ctypes table, and the dispatcher against the JAX
package's `_xla_group_norm` and `_pallas_group_norm` (the Pallas statistics
kernel in interpret mode, `GN.INTERPRET`, as `tests/test_torch_gn_route.py`
runs it).

The CUDA kernel runs only on the card, where `chip_smoke.py` phase 4c holds it
to `group_norm_reference` at every shape the rule sends it. On the CPU the
dispatcher is `group_norm_reference`, the one plain version of both the
one-launch kernel and the two-kernel route.

Layouts: JAX [B, N, C], the port [B, C, H, W] with N = H * W; inputs from a
seeded numpy rng. Tolerances: fp32 max |d| / max |JAX| 1e-5 (the order of
XLA's and ATen's sums); bf16 max |d| 2e-2 of max |plain| (the fp32 plain
version on the same values: both round the same fp32 math to bf16, so they
differ by about one bf16 ulp of a value, 2^-8 of max |plain| at most).
"""

import ast
import importlib.util
import os
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu.kernels import groupnorm as GN
from diffusion_e2e_ft_tpu_torch.kernels import _build
from diffusion_e2e_ft_tpu_torch.kernels import groupnorm as tgn
from diffusion_e2e_ft_tpu_torch.models import UNetConfig

CSRC = pathlib.Path(tgn.__file__).resolve().parent.parent / "csrc"
EPS = 1e-6
MAX_BLOCK_SMEM = 232448  # shared memory a block of the H100 can use (227 KB)
# (B, N, C), (H, W), groups: ragged n (63, 111 values a channel), 2 and 12 channels a group
SHAPES = [((2, 63, 64), (7, 9), 32), ((1, 111, 96), (3, 37), 8)]
JAX_IMPLS = {"xla": GN._xla_group_norm, "pallas": GN._pallas_group_norm}


@pytest.fixture(scope="module")
def chip_smoke():
    """`chip_smoke.py` as a module; the CUDA_VISIBLE_DEVICES it sets at import is undone after the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDA_VISIBLE_DEVICES", os.environ.get("CUDA_VISIBLE_DEVICES", ""))
        path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke_gn_group", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module


@pytest.fixture(scope="module")
def unet_visits(chip_smoke):
    """{(C, H, W)}: every standalone GroupNorm of the UNet at each of the 17 route paths (SD2's or GeoWizard's
    UNet at full width, on the meta device)."""
    out = set()
    for _, unet, hw, batches, *_ in chip_smoke.route_paths():
        config = UNetConfig.geowizard() if unet == "geowizard" else None
        for b in batches:
            out |= {shape[1:] for shape in chip_smoke.norm_visits("unet", b, hw, config=config)}
    return out


def test_group_rule_matches_the_kernel_source():
    src = (CSRC / "groupnorm.cu").read_text()
    found = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) for name in tgn.GROUP_RULE}
    assert found == tgn.GROUP_RULE
    # the fit's arithmetic, as the source writes it
    assert "return group_share_bytes(slab_bytes, parts) + 8LL * gs;" in src
    assert "return (slab_bytes / 16 + parts - 1) / parts * 16;" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_rule_sends_every_unet_groupnorm_to_one_launch(unet_visits, dtype):
    """At full width every UNet GroupNorm of the route paths fits a cluster: 76 (C, H, W), up to [960, 96, 96]
    (553 KB a slab in bf16, 1.1 MB in fp32)."""
    assert len(unet_visits) == 76 and (960, 96, 96) in unet_visits
    assert all(tgn.group_fits((1, *s), dtype, 32) for s in unet_visits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_rule_keeps_the_route_at_the_large_vae_layers(dtype):
    for shape in [(1, 256, 768, 768), (1, 128, 768, 768), (10, 256, 576, 768), (1, 256, 384, 384)]:
        assert not tgn.group_fits(shape, dtype, 32), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_no_one_launch_shape_exceeds_shared_memory(chip_smoke, dtype):
    """Every route shape that the rule sends to one launch fits the block's shared memory at its `parts`, on
    the H100's 132 SMs and on a card of 8: the share and the group's a, b within kGroupSmemBytes, and that
    beside the kernel's static shared memory (an mbarrier a chunk, two sums a warp, 4 floats) within 227 KB."""
    src = (CSRC / "groupnorm.cu").read_text()
    threads, chunk = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                      for k in ("kGroupThreads", "kGroupChunkBytes"))
    static = tgn.GROUP_RULE["kGroupSmemBytes"] // chunk * 8 + 2 * (threads // 32) * 4 + 4 * 4
    sent = [s for s in chip_smoke.route_shapes() if tgn.group_fits(s, dtype, 32)]
    assert len(sent) > 200
    for b, c, h, w in sent:
        gs = c // 32
        slab = gs * h * w * dtype.itemsize
        for sms in (132, 8):
            parts = tgn.group_parts(b * 32, slab, gs, sms)
            assert parts in (1, 2, 4, 8)
            smem = tgn.group_smem(slab, gs, parts)
            assert smem <= tgn.GROUP_RULE["kGroupSmemBytes"] and smem + static <= MAX_BLOCK_SMEM
            assert (slab // 16 + parts - 1) // parts <= smem // 16  # the largest share's vectors fit


def test_parts_fill_the_grid_at_batch_one():
    """At B = 1 (32 slabs) a large slab is split over 4 blocks (128 blocks on 132 SMs), a small one keeps 1;
    a slab that needs more blocks to fit takes them whatever the card; at B = 10 one block a slab."""
    bf16 = torch.bfloat16.itemsize
    assert tgn.group_parts(32, 10 * 96 * 96 * bf16, 10) == 4  # [1, 320, 96, 96]
    assert tgn.group_parts(32, 40 * 12 * 12 * bf16, 40) == 1  # [1, 1280, 12, 12]
    assert tgn.group_parts(32, 16 * 192 * 192 * bf16, 16) == 8  # [1, 512, 192, 192]: 1.18 MB
    assert tgn.group_parts(32, 16 * 192 * 192 * bf16, 16, sms=8) == 8
    assert tgn.group_parts(320, 10 * 60 * 80 * bf16, 10) == 1  # the baseline's [10, 320, 60, 80]
    assert tgn.group_parts(32, 8 * 384 * 384 * bf16, 8) == 0  # [1, 256, 384, 384]: the route


def test_chip_smoke_counts_one_launch_and_route(chip_smoke):
    """A bf16 768x768 request: 93 GroupNorms in one launch, 20 through statistics + apply (133 launches, where
    the two-kernel route everywhere takes 226); 576x768: 101 and 12; the fp32 256x256 parity image: 112 and 1."""
    assert chip_smoke.request_gn((768, 768), torch.bfloat16) == {"gn_group": 93, "gn_channel_stats": 20,
                                                                  "gn_apply": 20}
    assert chip_smoke.request_gn((576, 768), torch.bfloat16)["gn_group"] == 101
    assert chip_smoke.request_gn((256, 256), torch.float32)["gn_apply"] == 1
    # the bf16 train step: the fused VAE's decoder conv_norm_out at [2, 128, 480, 640] keeps the route
    assert chip_smoke.step_launches(15)["gn_apply"] == 1


def _slab_cut(length: int, n: int, head: int, parts: int, vec: int) -> np.ndarray:
    """The kernel's cut of one slab of `length` values: for each value, the channel its a, b come from, by the
    path that applies it (rank 0's scalar head, each rank's share of whole vectors, the last rank's scalar
    tail); -1 where no path reaches it."""
    head = min(head, length)
    nvec = (length - head) // vec
    channel = np.full(length, -1)
    channel[:head] = np.arange(head) // n
    for rank in range(parts):
        v0, v1 = nvec * rank // parts, nvec * (rank + 1) // parts
        for i in range(v1 - v0):
            e = head + (v0 + i) * vec
            c = e // n
            if e - c * n + vec <= n:
                assert (channel[e:e + vec] == -1).all()
                channel[e:e + vec] = c
            else:  # the vector crosses a channel boundary
                channel[e:e + vec] = [(e + j) // n for j in range(vec)]
    tail = head + nvec * vec
    channel[tail:] = np.arange(tail, length) // n
    return channel


@pytest.mark.parametrize("n,gs,head,parts,vec", [(63, 2, 0, 1, 8), (63, 2, 5, 4, 8), (1, 80, 3, 1, 8),
                                                 (9216, 10, 0, 4, 8), (1961, 10, 2, 2, 4), (5, 3, 7, 8, 4)],
                         ids=lambda v: str(v))
def test_slab_cut_covers_every_value_once(n, gs, head, parts, vec):
    channel = _slab_cut(gs * n, n, head, parts, vec)
    assert (channel == np.arange(gs * n) // n).all()


def _inputs(bnc, seed: int, loc: float = 0.5):
    rng = np.random.default_rng(seed)
    c = bnc[-1]
    x = (loc + rng.standard_normal(bnc)).astype(np.float32)
    return x, (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.5 * rng.standard_normal(c)).astype(np.float32)


def _to_port(x_bnc: np.ndarray, hw) -> torch.Tensor:
    b, _, c = x_bnc.shape
    return torch.from_numpy(np.ascontiguousarray(x_bnc.transpose(0, 2, 1))).reshape(b, c, *hw)


def _to_bnc(t: torch.Tensor) -> np.ndarray:
    return t.float().reshape(t.shape[0], t.shape[1], -1).permute(0, 2, 1).numpy()


@pytest.fixture(autouse=True)
def interpret_mode():
    GN.INTERPRET = True
    yield
    GN.INTERPRET = False


@pytest.mark.parametrize("affine", [torch.float32, torch.bfloat16], ids=["affine-fp32", "affine-bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("impl", list(JAX_IMPLS))
@pytest.mark.parametrize("case", range(len(SHAPES)), ids=["63-values-32-groups", "111-values-8-groups"])
def test_dispatcher_matches_jax(case, impl, dtype, affine):
    (bnc, hw, groups), silu = SHAPES[case], case == 0
    x, w, b = _inputs(bnc, 10 + case, loc=3.0 if case else 0.5)
    wt, bt = torch.from_numpy(w).to(affine), torch.from_numpy(b).to(affine)
    xt = _to_port(x, hw).to(dtype)
    got = tgn.group_norm_silu(xt, wt, bt, groups, EPS, silu)
    plain = tgn.group_norm_reference(xt, wt, bt, groups, EPS, silu)
    assert got.dtype == dtype and torch.equal(got, plain)  # the dispatcher on the CPU is the plain version
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(_to_bnc(xt), jdt)  # the same values: bf16 x rounded once, on the port's side
    jw, jb = (jnp.asarray(t.float().numpy(), jnp.bfloat16 if affine == torch.bfloat16 else jnp.float32)
              for t in (wt, bt))
    want = np.asarray(JAX_IMPLS[impl](jx, jw, jb, groups, EPS, silu)).astype(np.float32)
    err = np.abs(_to_bnc(got) - want).max()
    if dtype == torch.float32:
        assert err / np.abs(want).max() <= 1e-5
    else:
        ref = _to_bnc(tgn.group_norm_reference(xt.float(), wt.float(), bt.float(), groups, EPS, silu))
        assert err <= 2e-2 * np.abs(ref).max()


def test_group_norm_kernel_refuses_cpu_tensors(monkeypatch):
    """The one-call wrapper launches or raises: a CPU tensor never reaches the library, nothing is counted."""
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail("the library was reached"))
    x = torch.randn(1, 64, 4, 4)
    before = dict(tgn.launches)
    for args in ((x, torch.ones(64), torch.zeros(64)), (x.bfloat16(), torch.ones(64), torch.zeros(64))):
        with pytest.raises(ValueError, match="CUDA"):
            tgn.group_norm_kernel(*args, 32, EPS)
    assert tgn.launches == before and before.keys() == {"gn_channel_stats", "gn_apply", "gn_group"}


def _c_signatures(src: str) -> dict:
    """{name: [C parameter types]} of every `int e2eft_*(...)` definition in a source."""
    out = {}
    for name, params in re.findall(r"\bint (e2eft_\w+)\(([^)]*)\)\s*\{", src):
        out[name] = [re.sub(r"\s*\b\w+$", "", p.strip()).replace("const ", "") for p in params.split(",")]
    return out


def _ctypes_table() -> dict:
    """{name: [argtypes]} of `_build.load_library`'s table, read from its source (ptr, i32, i64, f32, and
    ctypes.POINTER(...) as 'ptr')."""
    tree = ast.parse(pathlib.Path(_build.__file__).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "load_library")
    env = {"ptr": "ptr", "i32": "i32", "i64": "i64", "f32": "f32"}
    table = None
    for node in fn.body:
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "flash":
                env["flash"] = [*["i32"] * 6, "f32", "ptr", "ptr"]
            if isinstance(target, ast.Name) and target.id == "signatures":
                table = node.value
    return {ast.literal_eval(k): eval(compile(ast.Expression(v), "<table>", "eval"), {}, env)
            for k, v in zip(table.keys, table.values)}


C_TYPES = {"void*": "ptr", "float*": "ptr", "int": "i32", "int64_t": "i64", "float": "f32"}


def test_ctypes_table_declares_group_norm_as_its_c_definition():
    table = _ctypes_table()
    c = _c_signatures((CSRC / "groupnorm.cu").read_text())
    assert len(table["e2eft_group_norm"]) == len(c["e2eft_group_norm"]) == 14
    assert table["e2eft_group_norm"] == [C_TYPES[t] for t in c["e2eft_group_norm"]]


@pytest.mark.parametrize("name", ["e2eft_gn_channel_stats", "e2eft_gn_apply", "e2eft_gn_silu_conv3x3",
                                  "e2eft_gn_silu_conv3x3_v2"])
def test_ctypes_table_matches_the_other_groupnorm_entry_points(name):
    src = "".join(p.read_text() for p in CSRC.glob("*.cu"))
    c = _c_signatures(src)
    assert _ctypes_table()[name] == [C_TYPES[t] for t in c[name]]
