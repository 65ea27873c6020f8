"""The port's tracer (``utils/profiling.py``): spans and counters, what a
render and a train step open and count, and the benchmark's readers of
them (``benchmarks/metrics/``), all on the CPU at tiny sizes."""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType

from benchmarks import spec
from hyper_ray_tracer_tpu_torch import (RenderSettings, build_scene,
                                        render_image)
from hyper_ray_tracer_tpu_torch.camera import make_basis
from hyper_ray_tracer_tpu_torch.render import prepare_scene
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
from hyper_ray_tracer_tpu_torch.train import make_train_step, pixel_lanes
from hyper_ray_tracer_tpu_torch.utils import profiling
from hyper_ray_tracer_tpu_torch.utils.profiling import (
    SpanTotal,
    count,
    counter,
    host_sync,
    since,
    snapshot,
    span,
)

W, H, SPP, DEPTH = 8, 6, 2, 3


def _render(name, **kw):
    return render_image(build_scene(name),
                        RenderSettings(W, H, SPP, DEPTH, **kw), "cpu")


def _cpu_events(fn):
    """The CPU events of a profile of ``fn()`` (the autograd profiler's
    CPU-only form, which starts in milliseconds where kineto's first
    capture in a process takes seconds)."""
    with torch.autograd.profiler.profile(use_kineto=False) as prof:
        fn()
    return [e for e in prof.function_events
            if e.device_type == DeviceType.CPU]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_nests_and_totals():
    before = snapshot()
    with span("test.outer"):
        with span("test.inner"):
            pass
        with span("test.inner"):
            pass

    @span("test.decorated")
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    got = since(before)["spans"]
    assert got["test.outer"].count == 1
    assert got["test.inner"].count == 2
    assert got["test.decorated"].count == 2
    assert got["test.outer"].ns >= got["test.inner"].ns > 0
    assert 0 < got["test.inner"].first_ns <= got["test.inner"].ns


def test_span_opens_a_range_under_the_profiler():
    def work():
        with span("test.outer"):
            with span("test.inner"):
                torch.ones(4).sum()

    ev = _cpu_events(work)
    outer = [e for e in ev if e.name == "test.outer"]
    inner = [e for e in ev if e.name == "test.inner"]
    assert len(outer) == 1 and len(inner) == 1
    assert _inside(inner[0], outer[0])


def test_count_snapshot_and_reset():
    before = snapshot()
    count("test.n")
    count("test.n", 4)
    assert host_sync("x") == "x"
    snap = snapshot()
    assert snap["counters"]["test.n"] - before["counters"].get("test.n", 0) \
        == 5
    assert counter("test.n") == snap["counters"]["test.n"]
    assert counter("test.absent") == 0
    snap["counters"]["test.n"] = -1  # a copy: the registry is untouched
    assert counter("test.n") == 5 + before["counters"].get("test.n", 0)
    assert since(before)["counters"]["syncs"] == 1
    profiling.reset()
    assert snapshot() == {"counters": {}, "spans": {}}


def test_render_opens_image_spans_in_order():
    ev = _cpu_events(lambda: _render("three-spheres"))
    image = [e for e in ev if e.name == "render_image"]
    assert len(image) == 1
    parts = [next(e for e in ev if e.name == n)
             for n in ("prepare", "upload", "finish")]
    assert all(_inside(p, image[0]) for p in parts)
    starts = [p.time_range.start for p in parts]
    assert starts == sorted(starts)
    chunk = [e for e in ev if e.name == "raygen"]
    assert chunk and all(parts[1].time_range.end <= c.time_range.start
                         <= parts[2].time_range.start for c in chunk)


def test_render_counts_rays_images_and_syncs():
    before = snapshot()
    _render("three-spheres", partition=False)
    got = since(before)
    assert got["counters"]["camera_rays"] == W * H * SPP
    assert got["counters"]["images"] == 1
    # one compaction after each bounce run, each a nonzero
    assert got["counters"]["syncs"] >= got["spans"]["compaction"].count > 0


@pytest.mark.parametrize("scene,kernel", [("one-sphere", "K1"),
                                          ("simple-light", "K1b")])
def test_sweep_twins_count_no_lanes_on_the_cpu(scene, kernel):
    before = snapshot()
    _render(scene)
    got = since(before)
    assert got["spans"]["trace"].count > 0
    assert f"{kernel}.lanes" not in got["counters"]
    assert f"{kernel}.launches" not in got["counters"]


def test_train_step_counts_a_step_and_binds_inside_forward():
    scene = build_scene("three-spheres")
    arrays, structure, mode = prepare_scene(scene, None)
    scene_t = to_device(arrays, scene.static, "cpu", structure)
    basis = make_basis(scene.camera, W, H)
    pix, sam = pixel_lanes(W, H, SPP, "cpu")
    target = torch.zeros((W * H, 3))
    init, step = make_train_step(scene, W, H, DEPTH, mode)
    state = init(scene_t)
    before = snapshot()
    ev = _cpu_events(lambda: step(state, scene_t, basis, pix, sam, 0,
                                  target))
    assert since(before)["counters"]["steps"] == 1
    (outer,) = [e for e in ev if e.name == "train_step"]
    (fwd,) = [e for e in ev if e.name == "forward"]
    (bind,) = [e for e in ev if e.name == "bind_params"]
    assert _inside(fwd, outer) and _inside(bind, fwd)


def _snap(counters, spans_ms):
    """A snapshot: ``spans_ms`` maps a span to (calls, total ms, first
    call's ms)."""
    return {"counters": counters,
            "spans": {k: SpanTotal(c, int(ms * 1e6), int(first * 1e6))
                      for k, (c, ms, first) in spans_ms.items()}}


READINGS = [
    ("image_host_ms.render",
     _snap({"images": 3}, {"prepare": (3, 3.0, 1.0), "upload": (3, 50.0, 30.0),
                           "finish": (3, 20.0, 10.0),
                           "render_image": (3, 900.0, 500.0)}), 16.0),
    ("image_host_ms.bvh_render",
     _snap({"images": 2}, {"prepare": (2, 400.0, 300.0),
                           "upload": (2, 100.0, 60.0),
                           "finish": (2, 9.0, 5.0)}), 144.0),
    ("bind_params_ms.fit",
     _snap({"steps": 10}, {"bind_params": (11, 130.0, 105.0),
                           "forward": (11, 900.0, 100.0)}), 2.5),
    ("syncs_per_mray.render",
     _snap({"syncs": 391, "camera_rays": 92_160_000}, {}), 391 / 92.16),
    ("syncs_per_mray.bvh_render",
     _snap({"syncs": 10, "camera_rays": 2_000_000}, {}), 5.0),
    ("syncs_per_step.fit", _snap({"syncs": 390, "steps": 10}, {}), 39.0),
    ("trace_lanes_per_ray.render",
     _snap({"K1b.lanes": 300, "K1.lanes": 50, "K5.lanes": 50, "K2.lanes": 7,
            "camera_rays": 100}, {}), 4.0),
    ("trace_lanes_per_ray.bvh_render",
     _snap({"K4.lanes": 230, "K3.lanes": 99, "camera_rays": 100}, {}), 2.3),
    ("shade_kernel_share.render",
     _snap({"K6.lanes": 240, "shade.lanes": 300, "K1b.lanes": 300}, {}),
     0.8),
    ("shade_kernel_share.bvh_render",
     _snap({"K6.lanes": 271, "shade.lanes": 271, "camera_rays": 100}, {}),
     1.0),
]


@pytest.mark.parametrize("name,snap,want", READINGS,
                         ids=[r[0] for r in READINGS])
def test_reader_takes_its_ratio(monkeypatch, name, snap, want):
    read = spec.metric_reader(name)
    monkeypatch.setitem(read.__globals__, "snapshot", lambda: snap)
    assert read(None) == pytest.approx(want, rel=1e-12)
    # nothing to divide by, nothing counted, or a span called once (its
    # cold call only): no reading
    monkeypatch.setitem(read.__globals__, "snapshot",
                        lambda: {"counters": {}, "spans": {}})
    assert read(None) is None
    once = {k: SpanTotal(1, v.ns, v.ns) for k, v in snap["spans"].items()}
    monkeypatch.setitem(read.__globals__, "snapshot",
                        lambda: {"counters": {}, "spans": once})
    assert read(None) is None
    monkeypatch.setitem(read.__globals__, "snapshot", lambda: None)
    assert read(None) is None
