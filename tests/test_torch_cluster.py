"""Cluster mode of the port against the JAX package and against the
port's own sweeps: the layout (``models/clusters.py``), the coherence key
and the launch order, the plain cluster sweep K5 is held to
(``ops/cluster_sweep.cluster_sweep_plain``) against the typed sweep, the
render, a two-level layout, a train step's gradients and the silhouette
correction.  K5 itself is held to ``cluster_sweep_plain`` in
tests/test_torch_cuda.py.

The JAX package's cluster renders and gradients cost its CPU trace and
compile a minute or more, so tier 1 holds the port to the JAX values
recorded in ``tests/golden_torch/cluster_jax.npz``; the ``slow`` test
recomputes them (``python tests/test_torch_cluster.py`` rewrites the
file).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

import hyper_ray_tracer_tpu as J  # noqa: E402
import hyper_ray_tracer_tpu.models.clusters as j_clusters  # noqa: E402
import hyper_ray_tracer_tpu.ops.cluster_sweep as j_cluster_sweep  # noqa: E402
from hyper_ray_tracer_tpu.camera import make_basis as j_make_basis  # noqa: E402
from hyper_ray_tracer_tpu.models.builders import (  # noqa: E402
    sphereflake as j_sphereflake,
)
from hyper_ray_tracer_tpu.render import block_order as j_block_order  # noqa: E402
from hyper_ray_tracer_tpu.render import prepare_scene as j_prepare  # noqa: E402
from hyper_ray_tracer_tpu.train import extract_params as j_extract  # noqa: E402
from hyper_ray_tracer_tpu.train import make_loss_fn as j_make_loss_fn  # noqa: E402

import hyper_ray_tracer_tpu_torch.models.clusters as p_clusters  # noqa: E402
import hyper_ray_tracer_tpu_torch.ops.cluster_sweep as p_cluster_sweep  # noqa: E402
from hyper_ray_tracer_tpu_torch import (  # noqa: E402
    SCENES,
    RenderSettings,
    build_scene,
    prepare_scene,
    render_image,
)
from hyper_ray_tracer_tpu_torch.__main__ import main  # noqa: E402
from hyper_ray_tracer_tpu_torch.camera import make_basis  # noqa: E402
from hyper_ray_tracer_tpu_torch.models.clusters import build_clusters  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops import edges as P  # noqa: E402
from hyper_ray_tracer_tpu_torch.ops.cluster_sweep import (  # noqa: E402
    cluster_sweep,
    cluster_sweep_plain,
    make_coherence_key,
)
from hyper_ray_tracer_tpu_torch.ops.intersect import (  # noqa: E402
    PrimFields,
    prim_hit_t,
)
from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (  # noqa: E402
    typed_sweep_plain,
)
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    T_MIN,
    block_order,
    resolve_intersector,
)
from hyper_ray_tracer_tpu_torch.scene_tensors import (  # noqa: E402
    bind_params,
    extract_params,
    to_device,
)
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    main as train_main,
)
from cluster_cases import (  # noqa: E402
    ENTRY_TIES,
    port_scene,
    tie_case,
    two_spheres_case,
    upload,
    waves,
)
from hyper_ray_tracer_tpu_torch.train import (  # noqa: E402
    make_loss_fn,
    params_from_jax,
    pixel_lanes,
)
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402

RECORD = Path(__file__).parent / "golden_torch" / "cluster_jax.npz"
# The renders of tests/test_cluster.py, at its shapes.
RENDERS = {"random": (24, 14, 2, 6), "final": (20, 12, 1, 6),
           "cornell": (20, 12, 1, 6), "sphereflake-3": (24, 14, 2, 6)}
# The train step's gradients: `final` (a moving-sphere run and a box run
# with pads among their slots, a tail of a light and two media) at
# 40x22, 1 spp, depth 3, where the geometry's gradients are not 0; the
# bounds of tests/test_torch_grad.py's `final` (its marble amplifies the
# ulp-level differences of the rays): loss rtol 1e-3, each key 3e-2 of
# its largest |g| (measured: loss 6.3e-6, geometry 1.2e-3, scale 3.5e-4).
GRAD_SCENE = "final"
GW, GH, GSPP, GDEPTH = 40, 22, 1, 3
GRAD_BOUNDS = (1e-3, 3e-2)
# The renders compared bit for bit with the sweep's: those of
# tests/test_cluster.py, all at 24x14x2 d6.
EQUAL_SHAPE = dict(width=24, height=14, samples=2, depth=6)


def _scene(name, port=True):
    if port:
        return port_scene(name)
    if name == "sphereflake-3":
        return j_sphereflake(3, "sphereflake-3")
    return J.build_scene(name)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


# --- the layout, the key, the launch order ---

@pytest.mark.parametrize("name", sorted(SCENES) + ["sphereflake-3"])
def test_build_clusters_equals_jax(name):
    scene = _scene(name)
    geom, lay = build_clusters(scene.arrays.geom, scene.static.n_prims)
    j_geom, j_lay = j_clusters.build_clusters(scene.arrays.geom,
                                              scene.static.n_prims)
    for field, a, b in zip(geom._fields, geom, j_geom):
        assert _same(a, b), field
    assert _same(lay.src, j_lay.src)
    assert lay.tail == j_lay.tail and lay.n_slots == j_lay.n_slots
    assert len(lay.runs) == len(j_lay.runs)
    for r, q in zip(lay.runs, j_lay.runs):
        for field, a, b in zip(r._fields, r, q):
            assert _same(a, b) if isinstance(a, np.ndarray) else a == b, \
                field
    assert p_clusters.cluster_eligible(scene.arrays.geom,
                                       scene.static.n_prims) == \
        j_clusters.cluster_eligible(scene.arrays.geom, scene.static.n_prims)


def test_layouts_of_the_scenes():
    """The shapes the kernel sees: `sphereflake` one sphere run of 256
    clusters x 264 slots, `final` a moving-sphere run of 4 x 256, a box
    run of 2 x 200 and a tail of 3, `random` 2 x 248, sphereflake(3)
    4 x 208, `cornell` all tail."""
    def shape(name):
        scene = _scene(name)
        _, lay = build_clusters(scene.arrays.geom, scene.static.n_prims)
        return ([(r.n_clusters, r.width) for r in lay.runs],
                sum(w for _, w, *_ in lay.tail))

    assert shape("sphereflake") == ([(256, 264)], 0)
    assert shape("final") == ([(4, 256), (2, 200)], 3)
    assert shape("random") == ([(2, 248)], 0)
    assert shape("sphereflake-3") == ([(4, 208)], 0)
    assert shape("cornell")[0] == []


def _seeded_rays(layout, n=2048, seed=0):
    """Rays from a NumPy seed: origins uniform in the box of the layout's
    typical clusters (as the coherence key bounds them), directions
    normal, random shutter times and bounce words, a tenth inactive."""
    rng = np.random.default_rng(seed)
    diag = np.linalg.norm(np.concatenate(
        [r.cmax - r.cmin for r in layout.runs]), axis=-1)
    typical = diag <= 8 * np.median(diag)
    lo = np.concatenate([r.cmin for r in layout.runs])[typical].min(0)
    hi = np.concatenate([r.cmax for r in layout.runs])[typical].max(0)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(rng.random(n).astype(np.float32)),
            torch.from_numpy(rng.random(n) < 0.9),
            torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64)))


@pytest.mark.parametrize("name", ["final", "random", "sphereflake-3"])
def test_coherence_key_equals_jax(name):
    scene = _scene(name)
    _, lay = build_clusters(scene.arrays.geom, scene.static.n_prims)
    o, d, *_ = _seeded_rays(lay, seed=5)
    got = make_coherence_key(lay)(o, d)
    want = np.asarray(j_cluster_sweep.make_coherence_key(lay)(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy())))
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert len(np.unique(want)) > 8


@pytest.mark.parametrize("w,h", [(400, 225), (24, 14), (64, 32), (65, 33)])
def test_block_order_is_a_permutation_and_the_jax_packages(w, h):
    perm = block_order(w, h)
    assert np.array_equal(np.sort(perm), np.arange(w * h))
    np.testing.assert_array_equal(perm, j_block_order(w, h))


# --- the trace ---

def _canonical(best, layout):
    src = torch.from_numpy(layout.src)
    return torch.where(best >= 0, src[best.clamp(min=0).long()].to(
        torch.int32), -1)


def _partings(scene, st, lay):
    """(hits, grazes, ties) of the cluster sweep against the typed sweep
    on the camera waves and on seeded rays from inside the scene; a lane
    parts when its winner, taken back to the canonical order through
    ``layout.src``, or its t differs."""
    sweep = to_device(scene.arrays, scene.static, "cpu")
    hits = grazes = ties = 0
    rays = list(waves(scene, sweep)) + [_seeded_rays(lay, seed=1)]
    for args in rays:
        t_c, b_c = cluster_sweep_plain(st.cluster, *args, T_MIN)
        t_s, b_s = typed_sweep_plain(sweep.sweep, *args, T_MIN)
        part = (_canonical(b_c, lay) != b_s) | (t_c != t_s)
        ties += int((part & (t_c == t_s)).sum())
        grazes += int((part & (t_c != t_s)).sum())
        hits += int((b_c >= 0).sum())
        inactive = ~args[3]
        assert (b_c[inactive] == -1).all() and (t_c[inactive] == 3.0e38).all()
    return hits, grazes, ties


@pytest.mark.parametrize("name", ["final", "random", "sphereflake-3"])
def test_plain_equals_typed_sweep_through_src(name):
    """On the camera waves and on seeded rays from inside the scene, the
    cluster sweep's winners, taken back to the canonical order through
    ``layout.src``, and t's equal the typed sweep's.  They could part
    only on a graze (a primitive's float32 t before its own cluster's box
    entry, or a medium's bound) or on an exact tie between two
    primitives; both are counted, and there are none."""
    scene = _scene(name)
    st, lay = upload(scene)
    hits, grazes, ties = _partings(scene, st, lay)
    assert (grazes, ties) == (0, 0)
    assert hits > 1000


@pytest.mark.parametrize("window", [16, 24])
def test_runs_longer_than_a_window(monkeypatch, window):
    """A run taken in several windows, each nearest first: sphereflake(3)
    at 16 primitives a cluster (64 clusters) in windows of 16 (four) and
    of 24 (a last window of 16); every box is tested once a ray, and the
    winners still equal the typed sweep's."""
    monkeypatch.setattr(p_clusters, "CLUSTER_TARGET_PRIMS", 16)
    monkeypatch.setattr(p_cluster_sweep, "WINDOW", window)
    scene = _scene("sphereflake-3")
    st, lay = upload(scene)
    assert lay.runs[0].n_clusters == 64
    hits, grazes, ties = _partings(scene, st, lay)
    assert (grazes, ties) == (0, 0) and hits > 1000
    o, d, tm, active, bits = next(waves(scene, st))
    stats = {}
    cluster_sweep_plain(st.cluster, o, d, tm, active, bits, T_MIN, stats)
    assert stats["box_tests"] == int(active.sum()) * 64


def _slots_tested(cs, ray, window=None, monkeypatch=None):
    if window is not None:
        monkeypatch.setattr(p_cluster_sweep, "WINDOW", window)
    stats = {}
    t, best = cluster_sweep_plain(cs, *ray, T_MIN, stats)
    return t, best, stats


def test_nearest_cluster_first(monkeypatch):
    """Cluster 0 holds a sphere at t = 7 (box entered at 7), cluster 1 one
    at t = 3 (box entered at 3).  Nearest first visits cluster 1 only:
    cluster 0's entry is then beyond the best.  Layout order (windows of
    one cluster) visits both.  The winner is the same."""
    cs, ray, first = two_spheres_case((8.0, 4.0), ((7.0, 9.0), (3.0, 5.0)))
    width = cs.layout.runs[0].width
    t, best, stats = _slots_tested(cs, ray)
    t_l, best_l, stats_l = _slots_tested(cs, ray, 1, monkeypatch)
    assert (int(best[0]), float(t[0])) == (first[1], 3.0)
    assert torch.equal(t, t_l) and torch.equal(best, best_l)
    assert stats["cluster_visits"] == 1 and stats_l["cluster_visits"] == 2
    tests = stats["prim_tests"]
    assert (tests[first[1]:first[1] + width] == 1).all()
    assert not tests[first[0]:first[0] + width].any()
    assert (stats_l["prim_tests"][first[0]:first[1] + width] == 1).all()


@pytest.mark.parametrize("z,boxes,winner,t_win", ENTRY_TIES)
def test_equal_entries_go_to_the_lower_cluster(z, boxes, winner, t_win):
    """Two boxes entered at the same t are visited lower cluster index
    first, as a stable sort orders them; the spheres lie before the boxes
    (a graze, built), so the cluster visited first wins and the other,
    its entry now beyond the best, is skipped."""
    cs, ray, first = two_spheres_case(z, boxes)
    stats = {}
    t, best = cluster_sweep_plain(cs, *ray, T_MIN, stats)
    assert (int(best[0]), float(t[0])) == (first[winner], t_win)
    assert stats["cluster_visits"] == 1


def test_nearest_first_tests_fewer_slots_than_layout_order(monkeypatch):
    """On sphereflake(3)'s camera wave, per-ray nearest first tests fewer
    slots than the first design's layout order (windows of one cluster,
    each visited while its entry is at or below the best), for the same
    winners and t's."""
    scene = _scene("sphereflake-3")
    st, lay = upload(scene)
    ray = next(waves(scene, st))
    t, best, stats = _slots_tested(st.cluster, ray)
    t_l, best_l, stats_l = _slots_tested(st.cluster, ray, 1, monkeypatch)
    assert torch.equal(t, t_l) and torch.equal(best, best_l)
    near, layout = (int(x["prim_tests"].sum()) for x in (stats, stats_l))
    assert near < layout, (near, layout)
    assert stats["cluster_visits"] < stats_l["cluster_visits"]


def test_prim_hit_t_takes_a_field_row_per_lane():
    """``prim_hit_t`` on [lanes, width] fields (a cluster a lane, as the
    plain sweep gathers them) equals it on each lane's [1, width] slice:
    `final`'s moving-sphere run and its box run."""
    scene = _scene("final")
    st, lay = upload(scene)
    cs = st.cluster
    o, d, tm, _, bits = next(waves(scene, st))
    lanes = torch.arange(0, o.shape[0], 37)
    for g, r in zip(cs.runs, lay.runs):
        first = r.base + (lanes % r.n_clusters) * r.width
        idx = first[:, None] + torch.arange(r.width)
        kw = dict(has_motion=g.motion, has_xform=g.xform,
                  rect_axis=g.rect_axis)
        bound = torch.full((lanes.numel(), 1), 3.0e38)
        got = prim_hit_t(g.ptype, PrimFields(*(x[idx] for x in cs.prims)),
                         o[lanes, None], d[lanes, None], tm[lanes, None],
                         T_MIN, bound, bits[lanes, None], **kw)
        for k, i in enumerate(lanes.tolist()):
            s = int(first[k])
            want = prim_hit_t(g.ptype, PrimFields(
                *(x[None, s:s + r.width] for x in cs.prims)), o[i:i + 1, None],
                d[i:i + 1, None], tm[i:i + 1, None], T_MIN, bound[k:k + 1],
                bits[i:i + 1, None], **kw)
            assert torch.equal(got[k:k + 1], want), (g.ptype, i)
        assert (got < 3.0e38).any()


def test_tie_goes_to_the_lowest_slot():
    """Slot b, a copy of the winner a at a higher slot, is tested first
    (in the tail) and gives the same t; a still wins: on an equal t the
    lower slot wins in any visit order."""
    cs, ray, a, t_a, b = tie_case()
    t, best = cluster_sweep_plain(cs, *ray, T_MIN)
    assert (int(best[0]), float(t[0])) == (a, t_a)


def test_wrapper_takes_plain_on_cpu_and_refuses_other_devices():
    scene = _scene("final")
    st, lay = upload(scene)
    args = next(waves(scene, st))
    before = counter("K5.launches")
    t, best = cluster_sweep(st.cluster, *args, T_MIN)
    assert counter("K5.launches") == before
    t_p, b_p = cluster_sweep_plain(st.cluster, *args, T_MIN)
    assert torch.equal(t, t_p) and torch.equal(best, b_p)
    assert t.dtype == torch.float32 and best.dtype == torch.int32
    with pytest.raises(ValueError, match="unsupported device"):
        cluster_sweep(st.cluster, *(x.to("meta") for x in args), T_MIN)


def test_plain_counts_the_tests_the_rays_need():
    scene = _scene("final")
    st, lay = upload(scene)
    o, d, tm, active, bits = next(waves(scene, st))
    stats = {}
    cluster_sweep_plain(st.cluster, o, d, tm, active, bits, T_MIN, stats)
    m = int(active.sum())
    n_clusters = sum(r.n_clusters for r in lay.runs)
    assert stats["box_tests"] == m * n_clusters
    tail = [s for s, w, *_ in lay.tail for s in range(s, s + w)]
    assert (stats["prim_tests"][tail] == m).all()
    assert 0 < int(stats["prim_tests"].sum()) < m * lay.n_slots
    # A visit tests every slot of its cluster once.
    firsts = [r.base + c * r.width for r in lay.runs
              for c in range(r.n_clusters)]
    assert stats["cluster_visits"] == int(stats["prim_tests"][firsts].sum())


# --- modes, uploads, renders ---

def test_resolve_and_prepare_cluster_mode():
    final = build_scene("final")
    assert resolve_intersector(final, "cluster") == "cluster"
    arrays, lay, mode = prepare_scene(final, "cluster")
    assert mode == "cluster" and lay.n_slots == arrays.geom.ptype.shape[0]
    assert lay.n_slots > final.static.n_prims
    st = to_device(arrays, final.static, "cpu", lay)
    assert st.mode == "cluster" and st.sweep is None and st.bvh is None
    assert st.fpack.shape[0] == lay.n_slots
    assert st.cluster.key is not None
    # Passed by keyword, the same upload (bit for bit: pads' geo is NaN).
    st2 = to_device(arrays, final.static, "cpu", clusters=lay)
    assert torch.equal(st2.cluster.geo.view(torch.int32),
                       st.cluster.geo.view(torch.int32))
    # An all-tail layout has no boxes and no coherence key.
    cornell = build_scene("cornell")
    st3, lay3 = upload(cornell)
    assert lay3.runs == () and st3.cluster.key is None
    assert st3.cluster.boxes.shape == (0, 8)


@pytest.mark.parametrize("name", ["random", "final", "cornell",
                                  "sphereflake-3"])
def test_render_equals_sweep(name):
    """Bit for bit: no lane grazes or ties on these renders (the trace
    test above counts them), and block order and the coherence sort are
    permutations."""
    scene = _scene(name)
    sweep = render_image(scene, RenderSettings(**EQUAL_SHAPE,
                                               intersector="sweep"), "cpu")
    clus = render_image(scene, RenderSettings(**EQUAL_SHAPE,
                                              intersector="cluster"), "cpu")
    np.testing.assert_array_equal(clus, sweep)
    assert (sweep.sum(-1) > 0).mean() > 0.005


def _record_values(name):
    return np.load(RECORD)[name]


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_matches_jax_cluster_mode(name):
    """The port's cluster render against the JAX package's (recorded),
    within tests/test_cluster.py's atol 1e-5 on every pixel where the
    two packages' sweep renders are (also recorded): the port's sweep
    render parts from the JAX package's on a few pixels, a path that
    diverged on an ulp (tests/test_torch_render.py), and cluster mode
    parts on those same pixels and no other, at most 1% of them (random
    3 of 336, final 1 of 240, sphereflake(3) 2 of 336, cornell none)."""
    w, h, spp, depth = RENDERS[name]
    scene = _scene(name)
    got = render_image(scene, RenderSettings(
        w, h, spp, depth, intersector="cluster"), "cpu")
    sweep = render_image(scene, RenderSettings(
        w, h, spp, depth, intersector="sweep"), "cpu")
    want = _record_values(f"render/{name}")
    want_sweep = _record_values(f"render_sweep/{name}")
    parts = (np.abs(got - want) > 1e-5).any(-1)
    sweep_parts = (np.abs(sweep - want_sweep) > 1e-5).any(-1)
    np.testing.assert_array_equal(parts, sweep_parts)
    assert parts.mean() <= 0.01, parts.sum()
    np.testing.assert_allclose(got[~parts], want[~parts], atol=1e-5, rtol=0)


def test_jax_arrays_carry_across():
    """The JAX package's cluster-mode arrays, through the port's
    conversion, are the port's own, array for array: both packages trace
    the same slots."""
    for name in ("final", "sphereflake-3"):
        j_arrays, _, j_mode = j_prepare(_scene(name, port=False), "cluster")
        arrays, lay, mode = prepare_scene(_scene(name), "cluster")
        assert (j_mode, mode) == ("cluster", "cluster")
        for field, a, b in zip(arrays.geom._fields, arrays.geom,
                               j_arrays.geom):
            assert _same(a, b), (name, field)
        st_j = to_device(j_arrays, _scene(name).static, "cpu", lay)
        st = to_device(arrays, _scene(name).static, "cpu", lay)
        for a, b in zip(st.cluster[3:-1], st_j.cluster[3:-1]):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_two_level_layout(monkeypatch):
    """A run of SUPER_MIN_CLUSTERS clusters or more, forced at test size
    as tests/test_cluster.py:183 forces it on the JAX side: the JAX
    package tests its super boxes first there, the port every cluster
    (the same result); the coherence key turns cell-first in both and
    stays equal, and the render still equals the sweep's."""
    for mod in (p_clusters, j_clusters):
        monkeypatch.setattr(mod, "CLUSTER_TARGET_PRIMS", 16)
    for mod in (p_cluster_sweep, j_cluster_sweep):
        monkeypatch.setattr(mod, "SUPER_MIN_CLUSTERS", 8)
    scene = _scene("sphereflake-3")
    _, lay = build_clusters(scene.arrays.geom, scene.static.n_prims)
    assert lay.runs[0].n_clusters == 64
    o, d, *_ = _seeded_rays(lay, seed=7)
    got = make_coherence_key(lay)(o, d)
    want = np.asarray(j_cluster_sweep.make_coherence_key(lay)(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy())))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    oc = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2
          + (d[:, 2] < 0).long())
    assert torch.equal(got & 7, oc)  # cell-first: the octant is last
    sweep = render_image(scene, RenderSettings(**EQUAL_SHAPE,
                                               intersector="sweep"), "cpu")
    clus = render_image(scene, RenderSettings(**EQUAL_SHAPE,
                                              intersector="cluster"), "cpu")
    np.testing.assert_array_equal(clus, sweep)


def test_cli_cluster_writes_png(tmp_path, caplog):
    out = tmp_path / "flake.png"
    assert main(["--cpu", "--scene", "final", "--intersector", "cluster",
                 "--width", "16", "--height", "9", "--samples", "1",
                 "--depth", "2", "--output", str(out)]) == 0
    from PIL import Image

    with Image.open(out) as im:
        assert im.size == (16, 9)
    assert "Intersector: cluster" in caplog.text


# --- training ---

def test_train_main_in_cluster_mode(capsys):
    assert train_main(["--cpu", "final", "8", "6", "1", "2",
                       "--intersector", "cluster", "--steps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["intersector"] == "cluster" and np.isfinite(out["loss"])


def _target():
    return np.random.default_rng(0).uniform(0, 1, (GW * GH, 3)).astype(
        np.float32)


def _port_grads(scene, params_np=None, intersector="cluster"):
    arrays, structure, mode = prepare_scene(scene, intersector)
    st = to_device(arrays, scene.static, "cpu", structure)
    params = (params_from_jax(params_np) if params_np is not None else
              {k: v.detach().clone().requires_grad_()
               for k, v in extract_params(st.arrays).items()})
    pix, sam = pixel_lanes(GW, GH, GSPP, "cpu")
    loss = make_loss_fn(scene, GW, GH, GDEPTH, mode)(
        params, st, make_basis(scene.camera, GW, GH), pix, sam, 0,
        torch.from_numpy(_target()))
    loss.backward()
    return loss.item(), {k: (p.grad.numpy() if p.grad is not None
                             else np.zeros(p.shape, np.float32))
                         for k, p in params.items()}, structure


def test_train_step_gradients_match_jax_cluster_mode():
    """The loss and every parameter's gradient in cluster mode against
    ``jax.grad`` of the JAX package's loss in cluster mode (recorded),
    within GRAD_BOUNDS; the pads' gradients are exactly 0 on both
    sides."""
    scene = _scene(GRAD_SCENE)
    j_arrays, _, _ = j_prepare(_scene(GRAD_SCENE, port=False), "cluster")
    params = {k: np.asarray(v) for k, v in j_extract(j_arrays).items()}
    loss, grads, lay = _port_grads(scene, params)
    rec = np.load(RECORD)
    loss_rtol, share = GRAD_BOUNDS
    np.testing.assert_allclose(loss, float(rec["grad/loss"]),
                               rtol=loss_rtol)
    pads = lay.src < 0
    assert pads.any()
    moved = 0
    for k, g in grads.items():
        ref = rec[f"grad/{k}"]
        assert np.isfinite(g).all() and g.shape == ref.shape, k
        if k.startswith("geom."):
            assert not g[pads].any() and not ref[pads].any(), k
        if np.abs(ref).max() > 0:
            moved += 1
            assert np.abs(g - ref).max() <= share * np.abs(ref).max(), k
        else:
            assert not g.any(), k
    assert moved >= 2 and np.abs(grads["geom.p0"]).max() > 0


def test_train_step_gradients_equal_sweep_mode():
    """The same loss in cluster and in sweep mode: the cluster mode's
    geometry gradients at each real slot are the sweep mode's at its
    source primitive (the same winners, the same arithmetic)."""
    scene = _scene(GRAD_SCENE)
    loss_c, g_c, lay = _port_grads(scene)
    loss_s, g_s, _ = _port_grads(scene, intersector="sweep")
    assert loss_c == loss_s
    real = lay.src >= 0
    for k in ("geom.p0", "geom.p1", "geom.radius"):
        np.testing.assert_allclose(g_c[k][real], g_s[k][lay.src[real]],
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    for k in ("materials.albedo", "textures.color1"):
        np.testing.assert_allclose(g_c[k], g_s[k], rtol=1e-5, atol=1e-8)


def test_cluster_mode_correction_equals_sweep_mode():
    """The silhouette correction in cluster mode takes its ids from the
    padded geometry the scene was uploaded from, as BVH mode does: by
    default every real slot of each family and no pad, and then its
    gradients are finite and 0 on the pads.  Given the sweep mode's ids
    taken to their slots (a sample's lens point and time follow its
    place in the ids, so both modes are given one order), its gradients
    are the sweep mode's at each real slot's source primitive, the
    probes traced through the cluster sweep.  At depth 1 a probe's
    radiance is what it hits first, whatever its RNG words."""
    scene = _scene("sphereflake-3")
    small = dict(n_edge=8, n_seg=4, mirror_pairs_max=2, n_probe=1)
    _, lay = build_clusters(scene.arrays.geom, scene.static.n_prims)
    real = lay.src >= 0
    slot_of = np.zeros(scene.static.n_prims, np.int64)
    slot_of[lay.src[real]] = np.flatnonzero(real)
    selectors = {"sphere_ids": P.sphere_ids_of, "rect_ids": P.rect_ids_of,
                 "box_ids": P.box_ids_of,
                 "mirror_ids": P.mirror_rect_ids_of,
                 "mirror_sphere_ids": P.mirror_sphere_ids_of,
                 "glass_sphere_ids": P.glass_sphere_ids_of,
                 "glass_shells": P.glass_shell_pairs_of}
    ids = {k: f(scene) for k, f in selectors.items()}
    assert len(ids["sphere_ids"]) == scene.static.n_prims
    w = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (GW * GH, 3)).astype(np.float32))

    def grads(mode, **kw):
        arrays, structure, _ = prepare_scene(scene, mode)
        st = to_device(arrays, scene.static, "cpu", structure)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in extract_params(st.arrays).items()}
        corr = P.make_silhouette_correction(scene, GW, GH, 1, st.host_geom,
                                            **small, **kw)
        img = corr(bind_params(st, params), make_basis(scene.camera, GW, GH),
                   7)
        assert torch.equal(img, torch.zeros_like(img))
        (img * w).sum().backward()
        return {k: p.grad.numpy() for k, p in params.items()
                if p.grad is not None}

    g_s = grads("sweep", **ids)
    g_c = grads("cluster", **{k: slot_of[v].astype(np.int32)
                              for k, v in ids.items()})
    g_d = grads("cluster")
    assert np.abs(g_s["geom.p0"]).max() > 0
    for k in ("geom.p0", "geom.radius"):
        np.testing.assert_allclose(g_c[k][real], g_s[k][lay.src[real]],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert not g_c[k][~real].any() and not g_d[k][~real].any(), k
        assert np.isfinite(g_d[k]).all() and np.abs(g_d[k]).max() > 0, k


# --- the JAX values ---

def _jax_values():
    out = {}
    for name, (w, h, spp, depth) in RENDERS.items():
        for key, mode in (("render", "cluster"), ("render_sweep", "sweep")):
            out[f"{key}/{name}"] = np.asarray(J.render_image(
                _scene(name, port=False),
                J.RenderSettings(w, h, spp, depth, intersector=mode)),
                np.float32)
    scene = _scene(GRAD_SCENE, port=False)
    arrays, bvh, mode = j_prepare(scene, "cluster")
    params = j_extract(arrays)
    pix = jnp.broadcast_to(jnp.arange(GW * GH, dtype=jnp.int32),
                           (GSPP, GW * GH))
    sam = jnp.broadcast_to(jnp.arange(GSPP, dtype=jnp.int32)[:, None],
                           (GSPP, GW * GH))
    loss, grads = jax.jit(jax.value_and_grad(
        j_make_loss_fn(scene, GW, GH, GDEPTH, mode)))(
        params, arrays, bvh, j_make_basis(scene.camera, GW, GH), pix, sam,
        np.uint32(0), jnp.asarray(_target()))
    out["grad/loss"] = np.float32(loss)
    for k, v in grads.items():
        out[f"grad/{k}"] = np.asarray(v, np.float32)
    return out


@pytest.mark.slow
def test_cluster_record_is_the_jax_packages():
    """The recorded values are what the JAX package computes now."""
    rec = np.load(RECORD)
    got = _jax_values()
    assert set(got) == set(rec.files)
    for k, v in got.items():
        np.testing.assert_allclose(v, rec[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


if __name__ == "__main__":
    np.savez_compressed(RECORD, **_jax_values())
    print("wrote", RECORD)
