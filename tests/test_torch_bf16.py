"""The port's last two render options against the JAX package:
``RenderSettings.bf16_hits`` (K1b's bf16 form, ``ops/typed_sweep.py``)
and ``RenderSettings.compaction``.

The bf16 form's twin rounds as the JAX package's jitted sweep does: each
three-term dot a float32 sum of products exact in float32, rounded to
bfloat16 once, every other operation one rounded bf16 operation.  Its
candidates equal the jitted ``_sphere_bf16_core``'s bit for bit, and its
winners the jitted ``make_scan_intersector``'s over the same plan (the
JAX package cuts the plan at the partition groups in sweep mode, so the
bf16 tiles are the same).  The JAX package run op by op rounds each
dot's products to bf16 before the sum, and so parts from both on a few
candidates.  The images stay within tests/test_bf16.py's drift bounds of
the port's float32 image and of the JAX package's bf16 image.

``python tests/test_torch_bf16.py`` rewrites ``golden_torch/bf16_jax.npz``
(the JAX package's bf16 images, ~30 s); the ``slow`` test recomputes them.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu import build_scene as j_build_scene  # noqa: E402
from hyper_ray_tracer_tpu.camera import make_basis as j_make_basis  # noqa: E402
from hyper_ray_tracer_tpu.ops import rng as jrng  # noqa: E402
from hyper_ray_tracer_tpu.ops.bvh import (  # noqa: E402
    _BF,
    _BIG_BF,
    _sphere_bf16_core,
    make_scan_intersector,
)
from hyper_ray_tracer_tpu.ops.partition import (  # noqa: E402
    partition_groups as j_partition_groups,
)
from hyper_ray_tracer_tpu.render import (  # noqa: E402
    RenderSettings as JRenderSettings,
)
from hyper_ray_tracer_tpu.render import T_MIN as J_T_MIN  # noqa: E402
from hyper_ray_tracer_tpu.render import make_ray_colorer  # noqa: E402
from hyper_ray_tracer_tpu.render import prepare_scene as j_prepare  # noqa: E402
from hyper_ray_tracer_tpu.render import render_image as j_render  # noqa: E402
from hyper_ray_tracer_tpu_torch import (  # noqa: E402
    RenderSettings,
    build_scene,
    prepare_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch import render as R  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.builders import sphereflake  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import partition as P  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import typed_sweep as ts  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.intersect import BIG  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.math import sqrt_rn  # noqa: E402
from hyper_ray_tracer_tpu_torch.scene_tensors import (  # noqa: E402
    bind_params,
    to_device,
)
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    extract_params,
    make_radiance_fn,
    pixel_lanes,
)

RECORD = Path(__file__).parent / "golden_torch" / "bf16_jax.npz"
# tests/test_bf16.py's cases: (scene, settings, bound on the mean |dI|).
IMAGES = [
    ("three-spheres", dict(width=48, height=27, samples=8, depth=5), 0.01),
    ("final", dict(width=24, height=14, samples=4, depth=5), 0.04),
    ("random", dict(width=24, height=14, samples=4, depth=5), 0.002),
]
T_MIN16 = float(torch.tensor(J_T_MIN).to(torch.bfloat16).float())


def _t(x):
    x = np.array(x)  # a writable copy
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(x)


def _jax_images():
    """The JAX package's bf16 images of IMAGES, keyed by scene."""
    return {name: np.asarray(j_render(j_build_scene(name), JRenderSettings(
        **s, intersector="sweep", bf16_hits=True)))
        for name, s, _ in IMAGES}


@pytest.fixture(scope="module")
def jax_images():
    with np.load(RECORD) as f:
        return {k: f[k] for k in f.files}


def test_render_settings_take_every_jax_field():
    import dataclasses

    port = {f.name for f in dataclasses.fields(RenderSettings)}
    ref = {f.name for f in dataclasses.fields(JRenderSettings)}
    assert ref <= port, ref - port
    s = RenderSettings(8, 8, 1, 1, compaction=False, bf16_hits=True)
    assert s.compaction is False and s.bf16_hits is True


def test_miss_value_is_above_big():
    """bf16(3.0e38) rounds up past float32's BIG, so a tile a lane misses
    never replaces its best; rays that miss every sphere return (BIG,
    -1)."""
    assert ts.BF16_BIG == float(np.float32(_BIG_BF)) > float(BIG)
    assert ts.BF16_BIG == float(torch.tensor(3.0e38).bfloat16().float())
    scene = build_scene("three-spheres")
    st = to_device(scene.arrays, scene.static, "cpu")
    n = 64
    o = torch.tensor([[0.0, 500.0, 0.0]]).repeat(n, 1)
    d = torch.nn.functional.normalize(
        torch.from_numpy(np.random.default_rng(0).uniform(
            -0.2, 0.2, (n, 3)).astype(np.float32)) + torch.tensor(
            [0.0, 1.0, 0.0]), dim=1)
    t, best = ts.typed_sweep_plain(st.sweep, o, d, torch.zeros(n),
                                   torch.ones(n, dtype=torch.bool),
                                   torch.zeros(n, dtype=torch.int64),
                                   J_T_MIN, bf16=True)
    assert (best == -1).all() and (t == float(BIG)).all()
    d16, a16, inv = ts.bf16_ray_terms(d[:, None])
    sw = st.sweep
    t16 = ts.sphere_t_bf16(sw.prims.p0[None], sw.geo16[None, :, 3].bfloat16(),
                           o[:, None], d16, a16, inv, T_MIN16,
                           torch.tensor(3.0e38).bfloat16())
    assert (t16.float() == ts.BF16_BIG).all()


def _core_inputs(n=2048, w=64):
    """Rays and spheres from a numpy seed: camera-like rays near the
    origin, a quarter of them secondary rays hundreds of units out, the
    r = 100 ground among the spheres, and bounds from a hit t to BIG."""
    rng = np.random.default_rng(7)
    c = rng.uniform(-5, 5, (1, w, 3)).astype(np.float32)
    r = rng.uniform(0.05, 2.0, (1, w)).astype(np.float32)
    c[0, 0], r[0, 0] = (0.0, -100.5, -1.0), 100.0
    o = rng.uniform(-6, 6, (n, 1, 3)).astype(np.float32)
    o[:n // 4] += rng.uniform(-400, 400, (n // 4, 1, 3)).astype(np.float32)
    d = rng.normal(size=(n, 1, 3)).astype(np.float32)
    t_max = rng.uniform(0.1, 1000.0, (n, 1)).astype(np.float32)
    t_max[:n // 3] = 3.0e38
    return c, r, o, d, t_max


def _jax_core(c, r, o, d, t_max, jit=True):
    """The JAX package's candidate core (jitted, as its sweep runs it, or
    op by op) and its per-ray terms a16, inv_a16, as float32 NumPy."""
    def core(c, r, o, d, t_max):
        d16 = d.astype(_BF)
        a16 = (d16 * d16).sum(-1)
        inv = _BF(1.0) / a16
        t = _sphere_bf16_core(c, r, o, d16, a16, inv,
                              jnp.asarray(J_T_MIN, _BF), t_max.astype(_BF))
        return [x.astype(jnp.float32) for x in (t, a16, inv)]

    fn = jax.jit(core) if jit else core
    return [np.asarray(x) for x in fn(*(jnp.asarray(x) for x in
                                         (c, r, o, d, t_max)))]


def _twin_core(c, r, o, d, t_max):
    d16, a16, inv = ts.bf16_ray_terms(_t(d))
    return ts.sphere_t_bf16(_t(c), ts.bf16_radius_sq(_t(r)).bfloat16(),
                            _t(o), d16, a16, inv, T_MIN16,
                            _t(t_max).bfloat16()).float().numpy()


def test_candidate_core_against_jax():
    """The twin's candidate t's against the JAX package's jitted
    ``_sphere_bf16_core``, ray by sphere, bit for bit (the r = 100
    ground, secondary rays hundreds of units out, bounds from a hit t to
    BIG)."""
    c, r, o, d, t_max = _core_inputs()
    ref, _, _ = _jax_core(c, r, o, d, t_max)
    got = _twin_core(c, r, o, d, t_max)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert (ref < 1e38).mean() > 0.01  # the cases do hit


def test_candidate_core_op_by_op_rounds_the_products():
    """The JAX package run op by op rounds each dot's products to bf16
    before their float32 sum: with that one change the twin's arithmetic
    gives the op-by-op core bit for bit, and without it the two part on
    a few candidates (measured 0.82% of the pairs)."""
    c, r, o, d, t_max = _core_inputs()
    ref, a16, inv = _jax_core(c, r, o, d, t_max, jit=False)
    bf = torch.bfloat16

    def dot(a, b):  # products rounded to bf16, then summed in float32
        return (a * b).float().sum(-1).to(bf)

    oc = (_t(o) - _t(c)).to(bf)
    d16 = _t(d).to(bf)
    half_b = dot(oc, d16)
    cc = dot(oc, oc) - ts.bf16_radius_sq(_t(r)).to(bf)
    disc = half_b * half_b - _t(a16).to(bf) * cc
    sq = sqrt_rn(torch.clamp(disc.float(), min=0.0)).to(bf)
    tn = (-half_b - sq) * _t(inv).to(bf)
    tf = (-half_b + sq) * _t(inv).to(bf)
    t16 = _t(t_max).to(bf)
    ok1 = (disc >= 0) & (tn >= T_MIN16) & (tn <= t16)
    ok2 = (disc >= 0) & (tf >= T_MIN16) & (tf <= t16)
    got = torch.where(ok1, tn, torch.where(ok2, tf, ts.BF16_BIG)).float()
    np.testing.assert_array_equal(got.numpy(), ref)
    parted = (_twin_core(c, r, o, d, t_max) != ref).mean()
    assert 0 < parted < 0.02, parted


def _wavefronts(name, W=32, H=18, bounces=2):
    """Camera rays and their first bounce (2 spp, 1,152 lanes) from the
    JAX package's own ``init_state`` / ``bounce_step``: (o, d, time,
    bits, active) per bounce, NumPy."""
    scene = j_build_scene(name)
    arrays, bvh, mode = j_prepare(scene, "sweep")
    colorer = make_ray_colorer(scene, W, H, 2, mode, differentiable=False)
    pix = jnp.asarray(np.tile(np.arange(W * H), 2), jnp.int32)
    smp = jnp.asarray(np.repeat(np.arange(2), W * H), jnp.int32)
    state = jax.jit(colorer.init_state)(j_make_basis(scene.camera, W, H),
                                        pix, smp, jnp.uint32(0))
    out = []
    for b in range(bounces):
        bits = jrng.bounce_base(state.base, jnp.uint32(b))
        out.append(tuple(np.asarray(x) for x in
                         (state.o, state.d, state.time, bits, state.alive)))
        state = jax.jit(colorer.bounce_step)(arrays, bvh, state,
                                             jnp.uint32(b))
    return scene, out


@pytest.mark.parametrize("name", ["three-spheres", "final"])
def test_twin_winners_against_jax_scan(name):
    """The twin's winners against ``make_scan_intersector(static,
    host_geom, bf16=True, part_groups)`` (the plan the JAX package's
    sweep-mode renderer builds) on 1,152 lanes a bounce: bit-equal, and
    so is t where the winner is a bf16 tile's; a float32 tile's t within
    the JAX package's jitted contractions of it."""
    scene, waves = _wavefronts(name)
    groups = j_partition_groups(scene.arrays.geom, scene.static.n_prims)
    scan = jax.jit(lambda *a: make_scan_intersector(
        scene.static, scene.arrays.geom, bf16=True, part_groups=groups)(
            *a[:4], J_T_MIN, *a[4:]))
    st = to_device(scene.arrays, scene.static, "cpu")
    low = np.zeros(scene.static.n_prims + 1, bool)  # index -1: a miss
    for tile in st.sweep.plan:
        low[tile.start:tile.start + tile.width] = ts.bf16_tile(tile)
    assert low.any()
    for b, (o, d, time, bits, active) in enumerate(waves):
        t_ref, b_ref = (np.asarray(x) for x in
                        scan(scene.arrays.geom, o, d, time, bits, active))
        t, best = ts.typed_sweep_plain(st.sweep, _t(o), _t(d), _t(time),
                                       _t(active), _t(bits), J_T_MIN,
                                       bf16=True)
        best, t = best.numpy(), t.numpy()
        np.testing.assert_array_equal(best, b_ref, err_msg=str(b))
        np.testing.assert_array_equal(t[low[best]], t_ref[low[best]])
        same = (best >= 0) & ~low[best]
        np.testing.assert_allclose(t[same], t_ref[same], rtol=5e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("name", ["random", "three-spheres", "final",
                                  "cornell"])
def test_bf16_engages_on_static_sphere_tiles_only(name):
    """`random`'s one 486-wide tile moves and `cornell` has no sphere, so
    the bf16 form never engages there; on `three-spheres` every tile, on
    `final` the thousand static spheres."""
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, "cpu")
    low = sum(t.width for t in st.sweep.plan if ts.bf16_tile(t))
    assert ts.bf16_engages(st.sweep) == (low > 0)
    assert low == {"random": 0, "three-spheres": 5, "final": 1000,
                   "cornell": 0}[name]


# The port's bf16 image against the JAX package's, mean |dI|: measured
# 7.2e-9 (`three-spheres`) and 2.9e-7 (`final`), the float32 tiles' ulps;
# `random` has no bf16 tile, and its float32 render parts from the JAX
# package's by 5.1e-4.  Held at:
JAX_GAP = {"three-spheres": 1e-6, "final": 1e-5, "random": 0.002}


@pytest.mark.parametrize("name,s,bound", IMAGES, ids=[c[0] for c in IMAGES])
def test_bf16_image_close_to_f32(name, s, bound, jax_images):
    """The port's bf16 image against its float32 image within
    tests/test_bf16.py's bounds at its sizes (measured 0.00348 / 0.0110
    / 0), and against the JAX package's bf16 image
    (golden_torch/bf16_jax.npz) within JAX_GAP."""
    scene = build_scene(name)
    img32 = render_image(scene, RenderSettings(**s, intersector="sweep"),
                         "cpu")
    img16 = render_image(scene, RenderSettings(**s, intersector="sweep",
                                               bf16_hits=True), "cpu")
    assert img16.shape == img32.shape and np.isfinite(img16).all()
    assert np.abs(img16 - img32).mean() < bound
    assert np.abs(img16 - jax_images[name]).mean() < JAX_GAP[name]
    if name == "random":  # no bf16 tile: the float32 trace, bit for bit
        np.testing.assert_array_equal(img16, img32)


@pytest.mark.slow
def test_jax_record_is_current(jax_images):
    """golden_torch/bf16_jax.npz is the JAX package's bf16 render of
    IMAGES (``python tests/test_torch_bf16.py`` rewrites it)."""
    for name, img in _jax_images().items():
        np.testing.assert_array_equal(img, jax_images[name], err_msg=name)


def test_bf16_flag_ignored_by_bvh_and_cluster():
    """BVH and cluster mode ignore the flag, byte for byte (the JAX
    package's tests/test_bf16.py cases)."""
    s = dict(width=16, height=10, samples=2, depth=3)
    scene = build_scene("cornell")
    a = render_image(scene, RenderSettings(**s, intersector="bvh"), "cpu")
    b = render_image(scene, RenderSettings(**s, intersector="bvh",
                                           bf16_hits=True), "cpu")
    np.testing.assert_array_equal(a, b)
    scene = sphereflake(3, "sphereflake-3")
    s = dict(width=24, height=14, samples=2, depth=4)
    a = render_image(scene, RenderSettings(**s, intersector="cluster"),
                     "cpu")
    b = render_image(scene, RenderSettings(**s, intersector="cluster",
                                           bf16_hits=True), "cpu")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["three-spheres", "final"])
def test_bf16_records_follow_the_parameters(name):
    """The bf16 form's records, one per primitive, are (p0,
    bf16(bf16(r)^2)) record for record: as uploaded, and again after an
    in-place adam step and ``bind_params``, so the kernel never reads a
    stale center or radius."""
    scene = build_scene(name)
    st = to_device(scene.arrays, scene.static, "cpu")
    n = scene.static.n_prims

    def check(sw, geom):
        assert sw.geo16.shape == (n, 4) and sw.geo16.is_contiguous()
        assert torch.equal(sw.geo16[:, :3], geom.p0[:n].detach())
        assert torch.equal(sw.geo16[:, 3],
                           ts.bf16_radius_sq(geom.radius[:n].detach()))

    check(st.sweep, st.arrays.geom)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    bound = bind_params(st, params)
    check(bound.sweep, bound.arrays.geom)
    assert not torch.equal(bound.sweep.geo16, st.sweep.geo16)
    assert bound.sweep.plan == st.sweep.plan


def test_bf16_gradients_flow_and_are_finite():
    """The float32 recompute keeps the gradients: the selection is a fixed
    decision and the selected primitive's geometry gets float32
    gradients (the JAX package's test, three-spheres 24x14 d3)."""
    W, H, D = 24, 14, 3
    scene = build_scene("three-spheres")
    st = to_device(scene.arrays, scene.static, "cpu")
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    pix, sam = pixel_lanes(W, H, 1, "cpu")
    radiance = make_radiance_fn(scene, W, H, D, "sweep", bf16_hits=True)
    rad, _ = radiance(params, st, make_basis(scene.camera, W, H), pix, sam,
                      0)
    rad.mean().backward()
    g = params["geom.p0"].grad
    assert torch.isfinite(g).all() and g.abs().max() > 0


# `final` at a size whose wavefronts would partition (PART_MIN_LANES
# lowered): the bf16 image must not depend on the chunk that probes.
PART_SHAPE = (32, 18, 4, 4)


@pytest.fixture(scope="module")
def final_bf16():
    """(scene, its bf16 render_image at PART_SHAPE, the same with
    ``partition=False``), PART_MIN_LANES lowered.  A partitioned bf16
    render differs from the plain one on a few pixels there (a bf16 hit
    outside a group's float32 box), so equality with the plain image
    shows that no schedule ran."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P, "PART_MIN_LANES", 256)
        scene = build_scene("final")
        W, H, spp, depth = PART_SHAPE
        return scene, *(render_image(scene, RenderSettings(
            W, H, spp, depth, bf16_hits=True, partition=part), "cpu")
            for part in (True, False))


def test_bf16_render_never_partitions(monkeypatch, final_bf16):
    """A bf16 render on `final` runs no partition schedule, where the
    float32 render of the same settings partitions, and equals the bf16
    render with ``partition=False`` byte for byte; nor does a bf16
    train forward."""
    scene, ref, plain = final_bf16
    np.testing.assert_array_equal(ref, plain)
    monkeypatch.setattr(P, "PART_MIN_LANES", 256)
    lanes, orders = R.PartitionSchedule.lanes, []

    def counted(self, *a):
        order, mask = lanes(self, *a)
        orders.append(order is not None)
        return order, mask

    monkeypatch.setattr(R.PartitionSchedule, "lanes", counted)
    W, H, spp, depth = PART_SHAPE
    render_image(scene, RenderSettings(W, H, 1, depth, bf16_hits=True),
                 "cpu")
    assert not orders
    render_image(scene, RenderSettings(W, H, 1, depth), "cpu")
    assert any(orders)  # the float32 render does partition
    radiance = make_radiance_fn(scene, 8, 6, 2, "sweep", partition=True,
                                bf16_hits=True)
    st = to_device(scene.arrays, scene.static, "cpu")
    params = extract_params(st.arrays)
    pix, sam = pixel_lanes(8, 6, 1, "cpu")
    radiance(params, st, make_basis(scene.camera, 8, 6), pix, sam, 0)
    assert radiance.schedule() is None


def test_sharded_bf16_render_equals_render_image(monkeypatch, final_bf16):
    """A rays-sharded bf16 render of `final` (each rank's ``run.local``,
    assembled in this process, a chunk of one sample) equals
    ``render_image``'s bf16 image bit for bit, though each rank's first
    chunk differs from the single render's."""
    from hyper_ray_tracer_tpu_torch.parallel import mesh as M
    from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (
        make_sharded_renderer,
        place_pixels,
        shard_lanes,
    )

    W, H, spp, depth = PART_SHAPE
    scene, ref, plain = final_bf16
    monkeypatch.setattr(P, "PART_MIN_LANES", 256)
    monkeypatch.setattr(R, "CHUNK_LANES", W * H // 2)
    arrays, structure, mode = prepare_scene(scene, None)
    scene_t = to_device(arrays, scene.static, "cpu", structure)
    mesh = M.RenderMesh(2, 1)
    run = make_sharded_renderer(scene, W, H, depth, mesh, mode,
                                bf16_hits=True)
    basis = make_basis(scene.camera, W, H)
    sums = [run.local(scene_t, basis, 0, spp, 0, r) for r in range(2)]
    pixels = [shard_lanes(mesh, r, W, H, 0, spp)[0][0] for r in range(2)]
    img = R.gamma_image(place_pixels(W * H, pixels, sums).numpy(), spp, W,
                        H)
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(img, plain)


def test_resumed_bf16_render_equals_render_image(monkeypatch, tmp_path,
                                                 final_bf16):
    """A bf16 render of `final` resumed from a checkpoint of its first
    sample (so its first chunk starts at sample 1) equals the
    uninterrupted render bit for bit."""
    ck = str(tmp_path / "r.ckpt")
    W, H, spp, depth = PART_SHAPE
    scene, ref, plain = final_bf16
    monkeypatch.setattr(P, "PART_MIN_LANES", 256)
    render_image(scene, RenderSettings(W, H, 1, depth, bf16_hits=True,
                                       checkpoint_path=ck), "cpu")
    matches, resumed = R.ckpt.meta_matches, []
    monkeypatch.setattr(R.ckpt, "meta_matches",
                        lambda *a: resumed.append(matches(*a)) or matches(*a))
    got = render_image(scene, RenderSettings(
        W, H, spp, depth, bf16_hits=True, checkpoint_path=ck, spp_chunk=1),
        "cpu")
    assert resumed == [True]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, plain)


def test_compaction_field_is_taken_and_changes_nothing():
    """``RenderSettings.compaction`` (the JAX package's field) is taken
    and ignored: the port always compacts, and ``compaction=False``
    renders the default's image byte for byte."""
    scene = build_scene("final")
    s = dict(width=16, height=9, samples=2, depth=3)
    np.testing.assert_array_equal(
        render_image(scene, RenderSettings(**s, compaction=False), "cpu"),
        render_image(scene, RenderSettings(**s), "cpu"))


if __name__ == "__main__":
    np.savez_compressed(RECORD, **_jax_images())
