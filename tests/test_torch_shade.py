"""The fused forward shading kernel K6 (``ops/shade.py``,
``csrc/shade.cu``) and ``render.shade_hits``' choice between it and the
eager path.

On the CPU: which calls take K6 (``render.fused_shading``), the lanes
every call counts, the column offsets and flags the wrapper derives
from ``shade_pack_layout`` and ``SceneStatic`` for every scene, and that
nothing here needs a card or nvcc.  On the card (the ``cuda`` marker;
they skip without one): K6 against the eager path forced on the card,
bounce by bounce, bit for bit in o, d, throughput, radiance and alive on
every scene, with ``bf16_hits``, partitioned, in cluster mode and on
ragged wavefronts with dead lanes; whole images; one launch a bounce.
"""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

from hyper_ray_tracer_tpu_torch import (RenderSettings, build_scene,
                                        render_image)
from hyper_ray_tracer_tpu_torch import render as R
from hyper_ray_tracer_tpu_torch.camera import make_basis
from hyper_ray_tracer_tpu_torch.models.builders import SCENES
from hyper_ray_tracer_tpu_torch.models.scene import MT_DIELECTRIC, MT_METAL
from hyper_ray_tracer_tpu_torch.ops import partition
from hyper_ray_tracer_tpu_torch.ops import rng as prng
from hyper_ray_tracer_tpu_torch.ops.intersect import (
    gather_prim_shade_packed,
    pack_prim_shade,
    shade_pack_layout,
)
from hyper_ray_tracer_tpu_torch.ops.shade import (
    FLAG_MOTION,
    FLAG_NOISE,
    FLAG_XFORM,
    PACK_FIELDS,
    pack_columns,
    shade_flags,
    shade_lanes,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import _convert, to_device
from hyper_ray_tracer_tpu_torch.utils import cuda_build
from hyper_ray_tracer_tpu_torch.utils.profiling import counter, since, \
    snapshot

torch.set_num_threads(1)

STATE_FIELDS = ("o", "d", "throughput", "radiance")


# --- CPU: the dispatch, the counter, the wrapper's host side ----------

def _stub(device="cuda", requires_grad=False):
    return types.SimpleNamespace(device=torch.device(device),
                                 requires_grad=requires_grad)


def _stub_inputs(grad_on=None):
    """A wavefront, t_hit and a scene of stand-ins on a CUDA device (no
    card needed: the predicate reads devices and flags only), with the
    input named ``grad_on`` requiring grad."""
    names = R.WavefrontState._fields + ("t_hit", "fpack", "images")
    x = {n: _stub(requires_grad=n == grad_on) for n in names}
    state = R.WavefrontState(*(x[n] for n in R.WavefrontState._fields))
    scene = types.SimpleNamespace(
        fpack=x["fpack"], tables=types.SimpleNamespace(images=x["images"]))
    return state, scene, x["t_hit"]


def test_fused_shading_takes_only_graph_free_card_wavefronts():
    state, scene, t_hit = _stub_inputs()
    assert R.fused_shading(state, scene, t_hit, False)
    assert not R.fused_shading(state, scene, t_hit, True)
    for name in ("o", "radiance", "t_hit", "fpack", "images"):
        state, scene, t_hit = _stub_inputs(grad_on=name)
        assert not R.fused_shading(state, scene, t_hit, False), name
        with torch.no_grad():  # no graph to keep: K6 (a probe's case)
            assert R.fused_shading(state, scene, t_hit, False), name
    cpu = R.WavefrontState(*(_stub("cpu") for _ in R.WavefrontState._fields))
    assert not R.fused_shading(cpu, scene, _stub("cpu"), False)


def test_cpu_render_counts_every_shaded_lane_and_launches_no_k6(
        monkeypatch):
    seen = []
    eager = R.shade_hits

    def spy(scene, background, state, *a, **kw):
        seen.append(state.o.shape[0])
        return eager(scene, background, state, *a, **kw)

    def no_nvcc():
        raise AssertionError("a CPU render looked for nvcc")

    monkeypatch.setattr(R, "shade_hits", spy)
    monkeypatch.setattr(cuda_build, "find_nvcc", no_nvcc)
    before = snapshot()
    render_image(build_scene("final"), RenderSettings(8, 6, 2, 4), "cpu")
    got = since(before)["counters"]
    assert len(seen) > 1 and got["shade.lanes"] == sum(seen)
    assert "K6.lanes" not in got and "K6.launches" not in got
    assert "shade" not in cuda_build._loaded


def test_shade_lanes_refuses_cpu_tensors():
    scene = build_scene("three-spheres")
    st = to_device(scene.arrays, scene.static, "cpu")
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        shade_lanes(st, z, z, z[:, 0], torch.zeros(4, dtype=torch.int64),
                    z[:, 0], torch.zeros(4, dtype=torch.int32),
                    torch.ones(4, dtype=torch.bool), z, z, None,
                    (R._SKY_WHITE, R._SKY_BLUE))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_columns_and_flags_follow_the_layout(name):
    """The offsets K6 reads each field at cut the joined row exactly as
    the eager gather does, and its flags are the scene's."""
    scene = build_scene(name)
    static = scene.static
    flags = shade_flags(static)
    for on, bit in ((static.has_ray_xform, FLAG_XFORM),
                    (static.has_motion, FLAG_MOTION),
                    (static.has_noise_tex, FLAG_NOISE)):
        assert bool(flags & bit) == bool(on)
    assert flags == flags & (FLAG_XFORM | FLAG_MOTION | FLAG_NOISE)

    cols = dict(zip(("width",) + PACK_FIELDS, pack_columns(static)))
    widths = dict(shade_pack_layout(static))
    fpack, ipack = pack_prim_shade(_convert(scene.arrays, "cpu"), static)
    assert cols["width"] == fpack.shape[1] == sum(widths.values())
    idx = torch.arange(fpack.shape[0])
    pf, sf = gather_prim_shade_packed(fpack, ipack, idx, static)
    eager = {**pf._asdict(), **sf._asdict()}
    for field in PACK_FIELDS:
        if field not in widths:
            assert cols[field] == -1 and eager[field] is None, field
            continue
        w = widths[field]
        cut = fpack[:, cols[field]:cols[field] + w]
        assert torch.equal(cut, eager[field].reshape(-1, w)), field
    mats = set(static.mat_types)
    assert (cols["fuzz"] >= 0) == (MT_METAL in mats)
    assert (cols["ior"] >= 0) == (MT_DIELECTRIC in mats)
    assert (cols["time0"] >= 0) == static.has_motion


# --- The card: K6 against the eager path on the card ------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K6 has no CPU form)")
    return torch.device("cuda")


def _bits(x):
    return x.contiguous().view(torch.int32)


def _parted(got, ref):
    """Lanes where the two states differ in any bit of o, d, throughput
    or radiance, or in alive."""
    lanes = got.alive != ref.alive
    for f in STATE_FIELDS:
        lanes |= (_bits(getattr(got, f)) != _bits(getattr(ref, f))).any(-1)
    return lanes


def _eager(monkeypatch, fn, *args, **kw):
    """``fn(*args, **kw)`` with shade_hits forced onto its eager path."""
    with monkeypatch.context() as m:
        m.setattr(R, "fused_shading", lambda *a: False)
        return fn(*args, **kw)


def _camera(scene, W, H, spp, dev, seed=7):
    pix = torch.arange(W * H, dtype=torch.int64, device=dev).repeat(spp)
    smp = torch.arange(spp, dtype=torch.int64,
                       device=dev).repeat_interleave(W * H)
    return R.init_state(make_basis(scene.camera, W, H), W, H, pix, smp,
                        seed)


def _bounces_both(monkeypatch, st, scene, state, depth, bf16=False):
    """Each bounce traced once and shaded both ways; the next bounce
    starts from the eager path's survivors.  Returns (lanes shaded,
    parted lanes, K6 launches)."""
    shaded = parted = 0
    launches = counter("K6.launches")
    for b in range(depth):
        bb = prng.bounce_base(state.base, b)
        t_hit, prim = R.trace(st, state, bb, bf16=bf16)
        got = R.shade_hits(st, scene.background, state, bb, t_hit, prim,
                           bf16_hits=bf16)
        ref = _eager(monkeypatch, R.shade_hits, st, scene.background, state,
                     bb, t_hit, prim, bf16_hits=bf16)
        shaded += state.o.shape[0]
        parted += int(_parted(got, ref).sum())
        keep = ref.alive.nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        state = R.WavefrontState(*(x.index_select(0, keep) for x in ref))
    return shaded, parted, counter("K6.launches") - launches, b + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_k6_equals_eager_on_every_scene(cuda, monkeypatch, name):
    scene = build_scene(name)
    arrays, structure, _ = R.prepare_scene(scene, None)
    st = to_device(arrays, scene.static, cuda, structure)
    state = _camera(scene, 64, 36, 2, cuda)
    shaded, parted, launches, bounces = _bounces_both(monkeypatch, st, scene,
                                                      state, 10)
    assert shaded >= 64 * 36 * 2 and launches == bounces
    assert parted == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["three-spheres", "final"])
def test_k6_equals_eager_with_bf16_hits(cuda, monkeypatch, name):
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, cuda)
    assert R.bf16_engages(st.sweep)
    _, parted, launches, bounces = _bounces_both(
        monkeypatch, st, scene, _camera(scene, 64, 36, 2, cuda), 6,
        bf16=True)
    assert launches == bounces and parted == 0


def _paths_both(monkeypatch, st, scene, state, depth, **kw):
    got = R.bounce_paths(st, scene.background, state, depth, **kw)
    ref = _eager(monkeypatch, R.bounce_paths, st, scene.background, state,
                 depth, **kw)
    return got, ref


@pytest.mark.cuda
def test_k6_equals_eager_on_a_partitioned_final(cuda, monkeypatch):
    monkeypatch.setattr(partition, "PART_MIN_LANES", 512)
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    state = _camera(scene, 64, 36, 2, cuda)
    got_s, ref_s = (R.PartitionSchedule(st.groups) for _ in range(2))
    got = R.bounce_paths(st, scene.background, state, 4, schedule=got_s)
    ref = _eager(monkeypatch, R.bounce_paths, st, scene.background, state,
                 4, schedule=ref_s)
    assert any(got_s.decisions) and got_s.decisions == ref_s.decisions
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.cuda
def test_k6_equals_eager_in_cluster_mode(cuda, monkeypatch):
    scene = build_scene("final")
    arrays, layout, mode = R.prepare_scene(scene, "cluster")
    st = to_device(arrays, scene.static, cuda, layout)
    assert mode == "cluster"
    got, ref = _paths_both(monkeypatch, st, scene,
                           _camera(scene, 64, 36, 2, cuda), 4, coherent=True)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1000])
def test_k6_ragged_wavefront_with_dead_lanes(cuda, monkeypatch, n):
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, cuda)
    state = _camera(scene, 40, 30, 1, cuda)
    state = R.WavefrontState(*(x[:n].contiguous() for x in state))
    gen = torch.Generator(device=cuda).manual_seed(n)
    state = state._replace(alive=torch.rand(n, device=cuda,
                                            generator=gen) < 0.7)
    bb = prng.bounce_base(state.base, 0)
    t_hit, prim = R.trace(st, state, bb)
    got = R.shade_hits(st, scene.background, state, bb, t_hit, prim)
    ref = _eager(monkeypatch, R.shade_hits, st, scene.background, state, bb,
                 t_hit, prim)
    assert int(_parted(got, ref).sum()) == 0
    assert not got.alive[~state.alive].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["final", "sphereflake"])
def test_render_image_equals_the_eager_image(cuda, monkeypatch, name):
    """A whole 160x90x4 image through K6 and through the eager path:
    parted pixels (any channel) 0."""
    scene = build_scene(name)
    settings = RenderSettings(160, 90, 4, 10)
    before = snapshot()
    img = render_image(scene, settings, cuda)
    got = since(before)["counters"]
    ref = _eager(monkeypatch, render_image, scene, settings, cuda)
    assert got["K6.lanes"] == got["shade.lanes"]
    assert int((img != ref).any(-1).sum()) == 0


@pytest.mark.cuda
def test_k6_launches_once_a_bounce(cuda):
    scene = build_scene("final")
    before = snapshot()
    render_image(scene, RenderSettings(64, 36, 1, 3), cuda)
    got = since(before)
    assert got["counters"]["K6.launches"] == got["spans"]["shade"].count
    assert got["counters"]["K6.lanes"] == got["counters"]["shade.lanes"]
    assert "K2.launches" not in got["counters"]


@pytest.mark.cuda
def test_profiler_links_k6_to_the_shade_span(cuda):
    """K6 launches inside its own operator, so a profile links its device
    time to the operator and the ``shade`` span around it, all of it."""
    from torch.profiler import ProfilerActivity, profile

    scene = build_scene("final")
    settings = RenderSettings(64, 36, 2, 4)
    render_image(scene, settings, cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_image(scene, settings, cuda)
        torch.cuda.synchronize()
    ev = prof.events()
    by_name = sum(e.time_range.elapsed_us() for e in ev
                  if e.device_type == DeviceType.CUDA
                  and "shade_kernel" in e.name)
    linked = sum(k.duration for e in ev if e.name == "hrt_torch::shade"
                 for k in e.kernels)
    in_span = sum(e.device_time_total for e in ev if e.name == "shade")
    assert by_name > 0
    assert linked == pytest.approx(by_name, rel=1e-6)
    assert in_span == pytest.approx(by_name, rel=1e-6)
