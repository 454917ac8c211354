"""The render's profiler spans (``profiling.span``) on the CPU: off, they
are one shared no-op; under ``torch.profiler`` a frame records each phase
of each wavefront round, and the frame is bitwise what it is untraced."""

import contextlib
import json

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import profiling  # noqa: E402
from tpu_pt_torch.render import (CameraArrays, init_accum,  # noqa: E402
                                 render_frame)

CFG = dict(width=16, height=16, spp=2, max_depth=3,
           use_direct_lighting=True, use_importance_sampling=True)
PHASES = ("pt.rng", "pt.intersect", "pt.shade", "pt.nee", "pt.queue")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(assets_dir):
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                          device="cpu")
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    return scene, cam


def _frame(port, cfg, frame=3):
    scene, cam = port
    return render_frame(scene, cam, cfg, frame, init_accum(cfg, device="cpu"))


def _spans(prof) -> dict:
    """``{name: [(start, end), ...]}`` of the ``pt.*`` host events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pt.") and "CPU" in str(e.device_type()):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("pt.round")
    assert off is profiling.span("pt.frame")
    assert isinstance(off, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:              # taken while no profiler recorded: nothing
            torch.ones(4).sum()
        with profiling.span("pt.round"):
            torch.ones(4).sum()
    assert {n: len(v) for n, v in _spans(prof).items()} == {"pt.round": 1}


@pytest.mark.parametrize("scheduler,bounces", [("pixelq", 1), ("regen", 2)])
def test_frame_records_every_phase_of_every_round(port, scheduler, bounces):
    cfg = tp.RenderConfig(**CFG, scheduler=scheduler, bounces_per_round=bounces)
    accum, img, stats = _frame(port, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_accum, t_img, t_stats = _frame(port, cfg)
    spans = _spans(prof)
    assert len(spans["pt.frame"]) == 1 and len(spans["pt.prepare"]) == 1
    iters = int(stats.wavefront_iterations)
    assert iters % bounces == 0
    rounds = sorted(spans["pt.round"])
    assert len(rounds) == iters // bounces > 1
    for lo, hi in rounds:
        for name in PHASES:
            assert any(lo <= s and e <= hi for s, e in spans[name]), (name, lo)
    # The loop test runs between rounds, in no round.
    assert all(a[1] <= b[0] for a, b in zip(rounds, rounds[1:]))
    # The spans add no op and move none: the frame is bitwise the same.
    assert torch.equal(t_accum, accum) and torch.equal(t_img, img)
    for field in ("rays_traced", "shadow_rays", "done_histogram",
                  "wavefront_iterations"):
        assert torch.equal(getattr(t_stats, field), getattr(stats, field))


def test_device_trace_holds_the_spans(port, tmp_path):
    cfg = tp.RenderConfig(**CFG)
    with profiling.device_trace(str(tmp_path / "trace")) as p:
        _frame(port, cfg)
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"pt.frame", "pt.prepare", "pt.round", *PHASES} <= names
    assert "pt.round" in {e.key for e in p.key_averages()}
