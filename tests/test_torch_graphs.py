"""CUDA graphs of the UNet and the CLIP image tower (`utils/graphs.py`).

On the CPU: a CPU call, a call under grad and a call with trainable
parameters never touch the cache and give the eager body's output; the key,
the first-eager / second-capture policy and the LRU bound against a stand-in
capture; a replay's copies and launch counts; the cache dropped where the
parameters may move; `_build.launch` recording under a capture; the request
span's graph counters absent off CUDA. On the card (marked `card`, skipped
without one): replays against the eager call, bitwise, at full width. The
file imports no JAX, so on a machine without it:

    python -m pytest tests/test_torch_graphs.py --noconftest -p no:cacheprovider -q
"""

import copy
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu_torch.kernels import _build
from diffusion_e2e_ft_tpu_torch.models import UNet2DCondition, UNetConfig, unet as unet_mod
from diffusion_e2e_ft_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModelWithProjection
from diffusion_e2e_ft_tpu_torch.utils import graphs, trace

TINY_VISION = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2, image_size=32,
                               patch_size=8, projection_dim=16)


def tiny_unet(**kw) -> UNet2DCondition:
    torch.manual_seed(0)
    return UNet2DCondition(UNetConfig.tiny(**kw)).eval().requires_grad_(False)


def unet_inputs(b=1, hw=(16, 16)):
    g = torch.Generator().manual_seed(1)
    return torch.randn(b, 8, *hw, generator=g), torch.randn(b, 2, 32, generator=g)


class StandIn:
    """A stand-in for `graphs.capture`: its Graph replays by calling the body
    eagerly; it records the calls it sees."""

    def __init__(self):
        self.captures, self.replays = [], []

    def __call__(self, fn, inputs):
        self.captures.append(tuple(None if x is None else x.shape for x in inputs))
        stand_in = self

        class Replay:
            def replay(self, args):
                stand_in.replays.append(tuple(None if x is None else x.shape for x in args))
                return fn(*args)

        return fn(*inputs), Replay()


@pytest.fixture
def counts(monkeypatch):
    monkeypatch.setattr(graphs, "counts", {"graph_replays": 0, "graph_misses": 0})
    return graphs.counts


# ---- CPU: the cache stays out of every call that is not a frozen CUDA call under inference mode -------------------


def test_a_cpu_call_never_creates_an_entry_and_gives_the_eager_output(counts):
    u = tiny_unet()
    x, ctx = unet_inputs()
    with torch.inference_mode():
        for _ in range(3):
            out = u(x, 999, ctx)
            assert torch.equal(out, u._forward(x, torch.as_tensor(999).expand(1), ctx, None))
    assert u._graphs.keys() == [] and counts == {"graph_replays": 0, "graph_misses": 0}


def test_a_grad_enabled_call_and_trainable_parameters_never_create_an_entry(counts):
    u = tiny_unet().requires_grad_(True)
    x, ctx = unet_inputs()
    out = u(x, 500, ctx)
    out.float().square().mean().backward()  # the trainers' path: grad on, parameters trainable
    assert u.conv_in.weight.grad is not None
    with torch.no_grad():
        assert torch.equal(u(x, 500, ctx), u._forward(x, torch.full((1,), 500), ctx, None))
    assert u._graphs.keys() == [] and counts["graph_misses"] == 0


def test_the_clip_tower_on_the_cpu_never_creates_an_entry(counts):
    torch.manual_seed(0)
    tower = CLIPVisionModelWithProjection(TINY_VISION).eval().requires_grad_(False)
    px = torch.randn(2, 3, 32, 32)
    with torch.inference_mode():
        out = tower(px)
        assert torch.equal(out, tower._forward(px)) and out.shape == (2, 16)
    assert tower._graphs.keys() == [] and counts["graph_misses"] == 0


@pytest.mark.parametrize("case", ["engages", "own_hook", "cpu", "grad", "trainable", "capturing", "hook", "pre_hook",
                                  "global"])
def test_engages_only_for_a_frozen_hookless_cuda_call_under_inference_mode_outside_a_capture(case, monkeypatch):
    u = tiny_unet()
    if case == "trainable":
        u.time_embedding.linear_1.bias.requires_grad_(True)  # one trainable parameter is enough
    if case == "hook":
        u.mid_block.resnets[0].register_forward_hook(lambda *a: None)  # e.g. tools/activation_diff.py
    if case == "pre_hook":
        u.conv_in.register_forward_pre_hook(lambda *a: None)
    if case == "own_hook":  # runs around the replay, as around the eager body
        u.register_forward_pre_hook(lambda *a: None)
    if case == "global":
        monkeypatch.setattr(torch.nn.modules.module, "_global_forward_hooks", {0: lambda *a: None})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    x = types.SimpleNamespace(is_cuda=case != "cpu")
    with torch.inference_mode(case != "grad"):
        assert u._graphs.engages(u, (x,)) == (case in ("engages", "own_hook"))


# ---- CPU: the key, the capture policy and the bound, against a stand-in capture ----------------------------------


def test_first_call_eager_second_captures_later_ones_replay(counts):
    standin = StandIn()
    cache = graphs.GraphCache(capture=standin)
    x, ctx = unet_inputs()
    calls = []

    def body(a, b):
        calls.append(a.shape)
        return a.sum() + b.sum()

    outs = [cache.run(body, (x, ctx)) for _ in range(4)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert standin.captures == [(x.shape, ctx.shape)]  # the second call
    assert len(standin.replays) == 2  # the third and fourth
    assert len(calls) == 4  # first, capture's warm-up, two stand-in replays
    assert counts == {"graph_replays": 2, "graph_misses": 2}


def test_the_key_is_each_inputs_shape_strides_dtype_device_and_the_kernels_options(counts, monkeypatch):
    monkeypatch.delenv("E2EFT_FA_HP", raising=False)
    cache = graphs.GraphCache(capture=StandIn())
    x, ctx = unet_inputs()
    body = lambda *a: a[0].sum()  # noqa: E731
    for inputs in [(x, ctx, None), (x, ctx, torch.zeros(1, 10)), (x[:, :, :8], ctx, None), (x.double(), ctx, None),
                   (torch.cat([x, x]), ctx, None), (x.contiguous(memory_format=torch.channels_last), ctx, None)]:
        cache.run(body, inputs)
    monkeypatch.setenv("E2EFT_FA_HP", "2")  # another kernel a call: another graph
    cache.run(body, (x, ctx, None))
    assert len(cache.keys()) == 4 and counts["graph_misses"] == 7  # the bound (4) evicted the first three
    assert cache.keys()[-1][0] == _build.options() and cache.keys()[-1][1] == (x.device, x.dtype, x.shape, x.stride())
    assert cache.keys()[-2][1][3] == (8 * 16 * 16, 1, 8 * 16, 8) and cache.keys()[-1][3] is None


def test_the_least_recently_used_key_goes_first_and_comes_back_as_a_first_sight(counts):
    standin = StandIn()
    cache = graphs.GraphCache(limit=2, capture=standin)
    a, b, c = (torch.zeros(n) for n in (1, 2, 3))
    body = lambda t: t + 1  # noqa: E731
    for t in (a, a, b, b, a, c):  # a captured, b captured, a replayed (most recent), c evicts b
        cache.run(body, (t,))
    assert [k[1][2] for k in cache.keys()] == [(1,), (3,)]
    assert cache.captured() == 1 and counts == {"graph_replays": 1, "graph_misses": 5}
    cache.run(body, (b,))  # b again: seen once more, eager, no capture
    assert len(standin.captures) == 2 and counts["graph_misses"] == 6
    assert graphs.GraphCache(limit=0, capture=standin).run(body, (a,)) is not None  # limit 0: always eager


def test_a_replay_copies_into_the_static_inputs_counts_its_launches_and_returns_a_clone():
    static = (torch.zeros(2), None, torch.zeros(3))
    output = torch.zeros(2)
    replayed = []
    fake = types.SimpleNamespace(replay=lambda: (replayed.append(1), output.copy_(static[0] * 2)))
    la, lb = {"k1": 0}, {"k2": 5}
    g = graphs.Graph(static, fake, output, ((la, "k1"), (la, "k1"), (lb, "k2"), (la, "k1")))
    out = g.replay((torch.tensor([1.0, 2.0]), None, torch.ones(3).expand(3)))
    assert torch.equal(static[2], torch.ones(3)) and torch.equal(out, torch.tensor([2.0, 4.0]))
    assert out.data_ptr() != output.data_ptr() and replayed == [1]
    assert la == {"k1": 3} and lb == {"k2": 6}


def test_launches_under_a_capture_are_recorded_and_not_counted(monkeypatch):
    monkeypatch.setattr(_build, "entry_point", lambda name: lambda *args: 0)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: -1, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    counts = {"a": 0, "b": 0}
    t = torch.zeros(1)
    _build.launch(counts, "a", t)
    with _build.recording() as recorded:
        _build.launch(counts, "a", t)
        _build.launch(counts, ("a", "b"), t)
    _build.launch(counts, ("a", "b"), t)
    assert counts == {"a": 2, "b": 1}
    assert recorded == [(counts, "a"), (counts, "a"), (counts, "b")]


def test_options_hold_every_environment_variable_a_kernel_wrapper_reads():
    read = set()
    for path in Path(_build.__file__).parent.glob("*.py"):
        read |= set(re.findall(r"os\.environ\.get\(\"(E2EFT_\w+)\"", path.read_text()))
    assert read and read == set(_build.OPTIONS)


# ---- CPU: the cache is dropped where the parameters may move ------------------------------------------------------


def filled(u: UNet2DCondition) -> UNet2DCondition:
    u._graphs = graphs.GraphCache(capture=StandIn())
    x, ctx = unet_inputs()
    for _ in range(2):
        u._graphs.run(u._forward, (x, torch.full((1,), 999), ctx, None))
    assert u._graphs.captured() == 1
    return u


@pytest.mark.parametrize("move", ["to", "float", "half", "load_state_dict", "load_state_dict_assign"])
def test_moving_or_loading_the_parameters_drops_the_cache(move, counts):
    u = filled(tiny_unet())
    state = {k: v.clone() for k, v in u.state_dict().items()}
    {"to": lambda: u.to(torch.float64), "float": u.float, "half": u.half,
     "load_state_dict": lambda: u.load_state_dict(state),
     "load_state_dict_assign": lambda: u.load_state_dict(state, assign=True)}[move]()
    assert u._graphs.keys() == [] and u._graphs._owned is None


def test_a_copy_of_a_module_starts_with_an_empty_cache(counts):
    u = filled(tiny_unet())
    assert copy.deepcopy(u)._graphs.keys() == [] and u._graphs.captured() == 1


# ---- CPU: the timestep and the request span ----------------------------------------------------------------------


@pytest.mark.parametrize("t", [999, 999.0, np.int64(3), torch.tensor(7), torch.tensor([5, 6]), torch.tensor(2.5)])
def test_a_timestep_becomes_the_b_vector_torch_as_tensor_made(t):
    sample = torch.zeros(2, 4, 1, 1)
    want = torch.as_tensor(t, device=sample.device)
    want = want.expand(2) if want.ndim == 0 else want
    got = unet_mod._timesteps(t, sample)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_request_span_records_no_graph_counters_off_cuda():
    trace.clear()
    with torch.autograd.profiler.profile():
        with trace.request("cpu"):
            pass
    spans = trace.spans()
    trace.clear()
    assert [s.name for s in spans] == ["request"] and spans[0].attrs is None


# ---- on the card -------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def on_card(module: torch.nn.Module, device) -> torch.nn.Module:
    """Seeded weights as the benchmark's: lecun-normal matrices, N(0, 0.1)
    biases and norm shifts, 1 + N(0, 0.1) norm scales (the norms' 1-D weights)."""
    torch.manual_seed(0)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn_like(p) * p[0].numel() ** -0.5)
            else:
                p.copy_(torch.randn_like(p) * 0.1 + name.endswith("weight"))
    return module.to(device, torch.bfloat16).eval().requires_grad_(False)


def replayed(module, *inputs, calls=4):
    """The eager output (grad off, inference mode off: the cache stays out),
    then `calls` calls under inference mode: first sight, capture, replays."""
    with torch.no_grad():
        eager = module(*inputs)
    with torch.inference_mode():
        outs = [module(*inputs) for _ in range(calls)]
    torch.cuda.synchronize()
    return eager, outs


@pytest.fixture(scope="module")
def sd2_unet(card):
    with torch.device("meta"):
        u = UNet2DCondition(UNetConfig.sd2())
    return on_card(u.to_empty(device=card), card)


@pytest.mark.card
@pytest.mark.parametrize("hw", [(72, 96), (96, 96)])  # the mix's 576x768 and 768x768 requests
def test_sd2_unet_replays_bitwise_at_the_mix_shapes(sd2_unet, card, hw, counts):
    g = torch.Generator(card).manual_seed(hw[0])
    x = torch.randn(1, 8, *hw, device=card, generator=g, dtype=torch.bfloat16)
    ctx = torch.randn(1, 77, 1024, device=card, generator=g, dtype=torch.bfloat16)
    eager, outs = replayed(sd2_unet, x, 999, ctx)
    assert all(torch.equal(o, eager) for o in outs)
    assert counts == {"graph_replays": 2, "graph_misses": 2} and sd2_unet._graphs.captured() >= 1


@pytest.mark.card
def test_sd2_unet_ensemble_batch_of_two_with_an_expanded_context(sd2_unet, card):
    g = torch.Generator(card).manual_seed(2)
    x = torch.randn(2, 8, 72, 96, device=card, generator=g, dtype=torch.bfloat16)
    ctx = torch.randn(1, 77, 1024, device=card, generator=g, dtype=torch.bfloat16).expand(2, -1, -1)
    eager, outs = replayed(sd2_unet, x, 999, ctx)
    assert all(torch.equal(o, eager) for o in outs)


@pytest.mark.card
def test_a_two_step_ddim_plan_replays_one_graph_with_each_steps_timestep(sd2_unet, card):
    g = torch.Generator(card).manual_seed(3)
    x = torch.randn(1, 8, 72, 96, device=card, generator=g, dtype=torch.bfloat16)
    ctx = torch.randn(1, 77, 1024, device=card, generator=g, dtype=torch.bfloat16)
    with torch.no_grad():
        eager = {t: sd2_unet(x, t, ctx) for t in (999, 499)}
    assert not torch.equal(eager[999], eager[499])
    with torch.inference_mode():
        for _ in range(3):  # first sight and capture at 999 / 499, then replays
            for t in (999, 499):
                assert torch.equal(sd2_unet(x, t, ctx), eager[t]), t


@pytest.mark.card
def test_weights_loaded_after_a_capture_reach_the_replays(sd2_unet, card):
    g = torch.Generator(card).manual_seed(4)
    x = torch.randn(1, 8, 72, 96, device=card, generator=g, dtype=torch.bfloat16)
    ctx = torch.randn(1, 77, 1024, device=card, generator=g, dtype=torch.bfloat16)
    _, before = replayed(sd2_unet, x, 999, ctx, calls=3)
    state = {k: v.clone() for k, v in sd2_unet.state_dict().items()}
    for assign, scale in ((False, 1.01), (True, 0.99)):  # in place; new tensors at new addresses
        sd2_unet.load_state_dict({k: v * scale if k.endswith("weight") else v for k, v in state.items()},
                                 assign=assign)
        sd2_unet.requires_grad_(False)
        eager, outs = replayed(sd2_unet, x, 999, ctx, calls=3)
        assert not torch.equal(eager, before[-1]) and all(torch.equal(o, eager) for o in outs)
    with torch.no_grad():  # in place: the same addresses, read by the next replay
        sd2_unet.conv_out.bias.add_(1.0)
        eager = sd2_unet(x, 999, ctx)
    with torch.inference_mode():
        assert torch.equal(sd2_unet(x, 999, ctx), eager)


@pytest.mark.card
def test_the_launch_counts_of_a_replay_are_the_eager_calls(sd2_unet, card):
    from diffusion_e2e_ft_tpu_torch.kernels import flash_attention as fa, groupnorm as gn

    g = torch.Generator(card).manual_seed(5)
    x = torch.randn(1, 8, 96, 96, device=card, generator=g, dtype=torch.bfloat16)
    ctx = torch.randn(1, 77, 1024, device=card, generator=g, dtype=torch.bfloat16)

    def launched(grad_mode):
        fa.reset_launches()
        gn.reset_launches()
        with grad_mode:
            sd2_unet(x, 999, ctx)
        return {**fa.launches, **gn.launches}

    eager = launched(torch.no_grad())
    per_call = [launched(torch.inference_mode()) for _ in range(4)]
    assert eager["flash_attention_fwd"] > 0 and eager["gn_group"] > 0
    assert all(c == eager for c in per_call), (eager, per_call)


@pytest.mark.card
def test_geowizard_unet_replays_bitwise_at_batch_two_with_class_labels(card, counts):
    with torch.device("meta"):
        u = UNet2DCondition(UNetConfig.geowizard())
    u = on_card(u.to_empty(device=card), card)
    g = torch.Generator(card).manual_seed(6)
    x = torch.randn(2, 8, 72, 96, device=card, generator=g, dtype=torch.bfloat16)
    ctx = torch.randn(2, 1, 768, device=card, generator=g, dtype=torch.bfloat16)
    labels = torch.tensor([[1.0, 0, 1, 0, 0, 0, 0, 0, 0, 0], [0, 1.0, 1, 0, 0, 0, 0, 0, 0, 0]], device=card)
    eager, outs = replayed(u, x, 999, ctx, labels)
    assert all(torch.equal(o, eager) for o in outs)
    assert counts == {"graph_replays": 2, "graph_misses": 2}


@pytest.mark.card
def test_the_clip_image_tower_replays_bitwise(card, counts):
    with torch.device("meta"):
        tower = CLIPVisionModelWithProjection(CLIPVisionConfig())
    tower = on_card(tower.to_empty(device=card), card)
    px = torch.randn(1, 3, 224, 224, device=card, generator=torch.Generator(card).manual_seed(7))
    for layout in (torch.contiguous_format, torch.channels_last):  # clip_preprocess gives channels_last pixels
        eager, outs = replayed(tower, px.contiguous(memory_format=layout))
        assert all(torch.equal(o, eager) for o in outs), layout
    assert counts == {"graph_replays": 4, "graph_misses": 4}
