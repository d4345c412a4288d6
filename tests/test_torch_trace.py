"""The port's spans (`utils/trace.py`) on the CPU with tiny pipelines: nothing
recorded and no clock read outside a profiler session; under one, the
serving path's span tree with one request id a request, on the clock of the
profiler's timestamps; the buffer's bound; the profiler's flag that gates
it; and `--profile_dir`'s `spans.jsonl`."""

import json
import time

import numpy as np
import pytest
import torch

from diffusion_e2e_ft_tpu_torch.cli.run_marigold import profiled
from diffusion_e2e_ft_tpu_torch.cli.serve import PipelineService
from diffusion_e2e_ft_tpu_torch.models import UNetConfig, VAEConfig
from diffusion_e2e_ft_tpu_torch.models import clip
from diffusion_e2e_ft_tpu_torch.pipelines import GeoWizardPipeline, MarigoldPipeline
from diffusion_e2e_ft_tpu_torch.utils import trace

RES = 16
IMAGE = np.random.default_rng(0).integers(0, 256, (12, 16, 3), dtype=np.uint8)
UNET = dict(block_out_channels=(32, 32), cross_attention_levels=(True, False), num_attention_heads=(2, 2),
            layers_per_block=1, norm_num_groups=8)
VAE = VAEConfig(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=4)
MARIGOLD_TREE = {"request": None, "pre": "request", "infer": "request", "encode": "infer", "unet": "infer",
                 "scheduler": "infer", "decode": "infer", "post": "request"}


@pytest.fixture(scope="module")
def service():
    pipe = MarigoldPipeline.from_random(UNetConfig.tiny(**UNET), VAE, device="cpu")
    svc = PipelineService(pipe, RES, 1)
    svc.predict(IMAGE, normals=False)  # warm
    return svc


@pytest.fixture(scope="module")
def geowizard():
    vision = clip.CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=1, num_heads=4, image_size=224,
                                   patch_size=32, projection_dim=32)
    pipe = GeoWizardPipeline.from_random(UNetConfig.tiny(**UNET, class_embed_proj_dim=10, joint_attention=True),
                                         VAE, vision, device="cpu")
    pipe(IMAGE, processing_res=RES, color_map=None)  # warm
    return pipe


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def traced(fn):
    """fn() under the profiler: (spans recorded, time.time_ns() before and after the session, the profile)."""
    t0 = time.time_ns()
    with torch.autograd.profiler.profile(use_cpu=True) as prof:
        fn()
    return trace.spans(), t0, time.time_ns(), prof


def check_tree(spans, tree):
    by_id = {s.span_id: s for s in spans}
    assert sorted(s.name for s in spans) == sorted(tree)
    root = next(s for s in spans if s.name == "request")
    for s in spans:
        assert s.request_id == root.span_id
        parent = by_id.get(s.parent_id)
        assert (parent.name if parent else None) == tree[s.name], s
        if parent:
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns, (s, parent)


def test_nothing_recorded_and_no_clock_read_without_a_profiler(service, monkeypatch):
    class NoClock:
        def time_ns(self):
            raise AssertionError("a clock was read outside a profiler session")

    monkeypatch.setattr(trace, "time", NoClock())
    assert not trace.recording()
    assert trace.span("unet") is trace.request("cpu") is trace._NO_SPAN
    service.predict(IMAGE, normals=False)
    assert trace.spans() == [] and trace.dropped() == 0


def test_a_marigold_request_records_its_span_tree_on_the_profilers_clock(service):
    spans, t0, t1, prof = traced(lambda: service.predict(IMAGE, normals=False))
    check_tree(spans, MARIGOLD_TREE)
    assert all(t0 <= s.t0_ns <= s.t1_ns <= t1 for s in spans)
    assert all(s.attrs is None for s in spans)  # the counters run on a CUDA device only
    request = next(s for s in spans if s.name == "request")
    convs = [e for e in prof.kineto_results.events() if e.name() == "aten::convolution"]
    assert convs and all(request.t0_ns <= e.start_ns() <= request.t1_ns for e in convs)
    unets = [s for s in spans if s.name == "unet"]
    assert any(unets[0].t0_ns <= e.start_ns() <= unets[0].t1_ns for e in convs)


def test_a_geowizard_call_is_its_own_request_and_records_the_clip_tower(geowizard):
    spans, _, _, _ = traced(lambda: geowizard(IMAGE, processing_res=RES, color_map=None))
    check_tree(spans, {**MARIGOLD_TREE, "image_encoder": "infer"})


def test_two_requests_get_distinct_ids(service):
    spans, _, _, _ = traced(lambda: [service.predict(IMAGE, normals=False) for _ in range(2)])
    roots = [s for s in spans if s.name == "request"]
    assert len(roots) == 2 and roots[0].request_id != roots[1].request_id
    for root in roots:
        check_tree([s for s in spans if s.request_id == root.request_id], MARIGOLD_TREE)


def test_the_buffer_keeps_the_newest_spans_and_counts_those_it_drops():
    buf = trace.SpanBuffer(3)
    for i in range(5):
        buf.add(trace.Span(f"s{i}", i, None, i, i, i + 1, None))
    assert [s.name for s in buf.spans()] == ["s2", "s3", "s4"] and buf.dropped() == 2
    buf.clear()
    assert buf.spans() == [] and buf.dropped() == 0


@pytest.mark.parametrize("session", ["autograd", "torch.profiler"])
def test_the_profilers_flag_rises_and_falls_around_a_session(session):
    make = {"autograd": lambda: torch.autograd.profiler.profile(use_cpu=True),
            "torch.profiler": lambda: torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])}
    assert not trace.recording()
    with make[session]():
        assert trace.recording()
        with trace.span("x"):
            pass
    assert not trace.recording()
    assert [s.name for s in trace.spans()] == ["x"]


def test_profile_dir_writes_the_spans_beside_the_trace(service, tmp_path):
    with profiled(str(tmp_path), torch.device("cpu")):
        service.predict(IMAGE, normals=False)
    assert (tmp_path / "trace.json").is_file()
    lines = [json.loads(line) for line in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert sorted(s["name"] for s in lines) == sorted(MARIGOLD_TREE)
    assert all(s["t0_ns"] <= s["t1_ns"] and set(s) == set(trace.Span._fields) for s in lines)
